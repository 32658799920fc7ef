"""device.ops_per_solve: device operations (kernels, copies, sets) in the
profiler's trace per profiled solve."""


def read(t):
    if not t.profiled_solves or t.window_ns is None:
        return None
    w0, w1 = t.window_ns
    count = sum(1 for _, s, e in t.device_events if e > w0 and s < w1)
    return count / t.profiled_solves if count else None
