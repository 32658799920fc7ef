"""The program's own spans and host-read counter
(``tensorkrylov_tpu_torch/utils/profiling.py``), as the metric readers see
them in a traced run.

The program keeps spans only while a profiler runs, so the solve records
whose root lies inside the profiled window (``Trace.window_ns``, the clock
both share) are those of the profiled solves. A version of the program
without spans gives no records, and every reader here then reports nothing.
Host milliseconds carry the profiler's overhead, so they are upper bounds,
as ``device.idle_pct`` is. Device milliseconds come from each span's timing
events; where a span has none (the CPU, in tests) its host milliseconds
stand for them.
"""
from __future__ import annotations

__all__ = ["records", "spans", "per_solve", "mean"]


def records(t) -> list:
    """The program's solve records of the profiled solves, oldest first."""
    if t.window_ns is None:
        return []
    try:
        from tensorkrylov_tpu_torch.utils import profiling
    except ImportError:
        return []
    get = getattr(profiling, "solve_records", None)
    if get is None:
        return []
    w0, w1 = t.window_ns
    return [r for r in get() if w0 <= r.root.start_ns and r.root.end_ns <= w1]


def spans(t, name: str) -> list:
    """Every span called `name` in the profiled solves."""
    return [s for r in records(t) for s in r.spans if s.name == name]


def _ms(s, clock: str) -> float:
    if clock == "device" and s.device_ms is not None:
        return s.device_ms
    return s.self_ms if clock == "self" else s.host_ms


def per_solve(t, name: str, clock: str):
    """The milliseconds of every `name` span summed, over the profiled
    solves: clock 'host' (the span's wall), 'self' (its wall less its child
    spans') or 'device'. None where there is no such span."""
    recs = records(t)
    got = [s for r in recs for s in r.spans if s.name == name]
    return sum(_ms(s, clock) for s in got) / len(recs) if got else None


def mean(t, name: str, clock: str):
    """The mean milliseconds of a `name` span, as per_solve's clock says."""
    got = spans(t, name)
    return sum(_ms(s, clock) for s in got) / len(got) if got else None
