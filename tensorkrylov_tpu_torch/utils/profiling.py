"""Profiling hooks: counterpart of ``tensorkrylov_tpu/utils/profiling.py``.

``device_trace`` writes a ``torch.profiler`` trace that TensorBoard or
Perfetto read. ``span`` marks a stretch of the program: ``solve`` and
``solve_deflated`` open a root span each call and spans at their layers
inside it, and ``host_read`` counts each read of a device value into
Python, and each call that waits for the device as a read does. Spans are
on only while a ``torch.profiler`` session is active or inside
``tracing()``; off, ``span`` is one flag check and a shared null context,
and ``host_read`` one more.

    with profiling.tracing():
        tkt.solve(op, b, cfg)
    rec = profiling.solve_records()[-1]
    rec.root.host_ms, rec.root.host_reads, [(s.name, s.self_ms, s.device_ms) for s in rec.spans]

Each span stamps its start and end with ``time.time_ns()``, the Unix-epoch
nanoseconds that the profiler's events carry, so a record can be laid
against a trace. Under the profiler each span is also a ``tk:<name>`` range
(``record_function``'s). On a CUDA device each span records
a pair of timing events on the device's current stream; their
milliseconds (``device_ms``: the device's clock from the span's first
queued work to its last, idle time included) are read once, when the root
closes, which waits for the root's last event. No span synchronizes
anywhere else.

The JAX package's ``compiled_cost`` reads XLA's cost analysis of a jitted
call; eager PyTorch has no compiled program to ask, so it raises here.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import time
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast as _Range    # record_function's, at a few µs a range
from torch.autograd import profiler as _autograd_profiler

__all__ = ["device_trace", "span", "tracing", "host_read", "solve_records", "Span", "SolveRecord",
           "compiled_cost"]

RECORDS_KEPT = 64

# process-wide, as the profiler is: the open spans innermost last, the
# finished solves, and how many tracing() blocks are open
_STACK: List["Span"] = []
_RECORDS: "collections.deque[SolveRecord]" = collections.deque(maxlen=RECORDS_KEPT)
_IDS = itertools.count(1)
_TRACING = 0
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a CPU and, where there is a card, CUDA trace into logdir as a
    Chrome trace (``<logdir>/trace_<pid>_<n>.json``, which Perfetto and
    TensorBoard's profile plugin open); the program's spans appear in it as
    ``tk:`` ranges:

        with device_trace('/tmp/tk_trace'):
            tkt.solve(op, b, cfg)
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        count = len([f for f in os.listdir(logdir) if f.startswith(f"trace_{os.getpid()}_")])
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{count}.json"))


class Span:
    """One span of a solve record: its name, its parent (None for the root),
    the record's solve id, its start and end (``time.time_ns()``), the reads
    of device values made inside it (``host_reads``, its children's
    included), and on a CUDA device its device milliseconds."""

    __slots__ = ("name", "parent", "solve_id", "start_ns", "end_ns", "host_reads", "child_ns", "device_ms",
                 "device", "_spans", "_events", "_range")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name = name
        self.device = device
        self.parent: Optional[Span] = None
        self.solve_id = 0
        self.start_ns = self.end_ns = 0
        self.host_reads = 0
        self.child_ns = 0
        self.device_ms: Optional[float] = None
        self._spans: List[Span] = []
        self._events = None
        self._range = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        """host_ms less the time its child spans cover."""
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6

    def __enter__(self) -> "Span":
        parent = _STACK[-1] if _STACK else None
        if parent is None:
            self.solve_id = next(_IDS)
        else:
            self.parent, self.solve_id, self._spans = parent, parent.solve_id, parent._spans
            self.device = parent.device
        self._spans.append(self)
        _STACK.append(self)
        # the stamps sit next to the range's own ends; an event's record may
        # wait for room in a full launch queue
        if _autograd_profiler._is_profiler_enabled:
            self._range = _Range("tk:" + self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        if self.device is not None and self.device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self.device))
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _STACK.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += self.end_ns - self.start_ns
            parent.host_reads += self.host_reads
            return
        spans = tuple(self._spans)
        if self._events is not None:
            self._events[1].synchronize()
            for s in spans:
                s.device_ms = s._events[0].elapsed_time(s._events[1])
        for s in spans:
            s._spans, s._events, s._range = [], None, None
        _RECORDS.append(SolveRecord(self.solve_id, spans))


class SolveRecord(NamedTuple):
    """A finished root span and every span opened inside it, in the order
    they opened (spans[0] is the root)."""

    solve_id: int
    spans: Tuple[Span, ...]

    @property
    def root(self) -> Span:
        return self.spans[0]


def span(name: str, device: Optional[torch.device] = None):
    """A context manager marking the stretch it encloses as span `name`. A
    span given `device` (the solve's device) with no span open is a root: it
    starts a new solve record, and `device` says whether its spans record
    CUDA events. Inside a root a span is its child and takes its device;
    outside any root a span without `device` (a layer called on its own) is
    the shared null context, as every span is when off (no profiler, no
    tracing())."""
    if not (_TRACING or _autograd_profiler._is_profiler_enabled) or not (_STACK or device is not None):
        return _NULL
    return Span(name, device)


@contextlib.contextmanager
def tracing():
    """Spans on inside the block, without the profiler."""
    global _TRACING
    _TRACING += 1
    try:
        yield
    finally:
        _TRACING -= 1


def host_read(x, to=torch.Tensor.cpu):
    """to(x), a read of x into host memory (``bool``, ``int``, ``float``,
    ``torch.Tensor.cpu``, ``.item``, ``.tolist``) or a call that waits for x
    as such a read does (``torch.linalg.eig``, which on a CUDA tensor
    synchronizes the card with the host), returned as the bare call returns
    it. While spans are on, a tensor read on its root's device type adds one
    to the innermost open span's host_reads (on a CUDA solve, each is a wait
    for the card's queue to drain)."""
    if _STACK and isinstance(x, torch.Tensor):
        top = _STACK[-1]
        if top.device is None or x.device.type == top.device.type:
            top.host_reads += 1
    return to(x)


def solve_records() -> List[SolveRecord]:
    """The last RECORDS_KEPT finished root spans, oldest first."""
    return list(_RECORDS)


def compiled_cost(fn, *args, static_argnames=()):
    """XLA's FLOP and byte estimates of a jitted call have no counterpart."""
    raise NotImplementedError("compiled_cost reads XLA's cost analysis of a compiled program, which eager PyTorch "
                              "does not make; time the call under tracing() or trace it with device_trace "
                              "(ROADMAP.md Queue 1, #10)")
