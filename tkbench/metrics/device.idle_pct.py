"""device.idle_pct: 100·(1 − busy / wall) over the profiled solves, busy being
the union of the device's kernel, copy and set intervals in the profiler's
trace and wall the profiled window (the profiler's host overhead included,
so this is an upper bound on the unprofiled idle share)."""
from tkbench.tracing import busy_and_gaps


def read(t):
    busy, _ = busy_and_gaps(t)
    if busy <= 0 or t.window_ns is None:
        return None
    return 100.0 * (1.0 - busy / ((t.window_ns[1] - t.window_ns[0]) / 1e9))
