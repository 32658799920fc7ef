"""What a traced run records, from the benchmark's side of the program.

Two kinds of solve, never mixed:

* span solves: each function a metric names in its ``SPANS`` is wrapped so
  that the device is synchronized before and after every call, and the
  seconds between go to that span's list. The syncs inflate the layer
  times, so no end-to-end number comes from these solves;
* profiled solves: ``torch.profiler`` over a run of consecutive solves, kept
  in memory (no trace file). The same functions carry a ``record_function``
  label (no sync), so an idle gap can be put down to the layer the host was
  in, and each function a metric names in its ``RECORDS`` notes its
  arguments' shapes, so a kernel's launches can be given their work.

Each device event keeps its card index beside it, so that a cell on several
cards can take busy time card by card.
"""
from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["Trace", "sync", "spans", "profiled", "busy_and_gaps"]


class Trace:
    """Everything a metric reader may read. Lists stay empty where the run
    had nothing to record."""

    def __init__(self, peaks: dict):
        self.peaks = peaks              # tkbench/peaks.json
        self.walls: List[float] = []    # seconds of each timed solve in the window
        self.window_s = None            # the window's wall seconds, every solve and gap in it
        self.copy_s = 0.0               # the harness's copies of checked answers inside the window
        self.results: List[dict] = []   # status, niterations of every solve in the window
        self.setup_s = None
        self.peak_bytes = None
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.span_solves = 0
        self.records: Dict[str, List[tuple]] = defaultdict(list)
        self.device_events: List[tuple] = []   # (name, start_ns, end_ns) on the device, every card's
        self.card_events: Dict[int, List[tuple]] = defaultdict(list)   # the same rows by card index
        self.cards: List[int] = []             # a cell's CUDA cards where it has several, the lead first
        self.host_events: List[tuple] = []     # (name, start_ns, end_ns) on the host
        self.profiled_solves = 0
        self.window_ns = None                  # (start, end) of the profiled solves, profiler clock


def _targets(specs):
    """(spec, owner, name) of each spec's function: attr names a function of
    the module, or with a dot a method of one of its classes
    ('RingLaunch.__call__')."""
    for spec in specs:
        owner = importlib.import_module(spec["module"])
        *path, name = spec["attr"].split(".")
        for part in path:
            owner = getattr(owner, part)
        yield spec, owner, name


@contextlib.contextmanager
def _patched(specs, wrap: Callable):
    saved = []
    try:
        for spec, mod, attr in _targets(specs):
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, wrap(spec, fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def sync(devices):
    """Wait for every CUDA device among `devices`."""
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def spans(specs, trace: Trace, device):
    """Synchronized timers around each spec's function. A spec with
    ``factory: true`` names a function that returns the callable to time
    (the solver's step is built once per solve)."""

    def timed(name, fn):
        def run(*args, **kwargs):
            sync((device,))
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync((device,))
            trace.spans[name].append(time.perf_counter() - t0)
            return out
        return run

    def wrap(spec, fn):
        if spec.get("factory"):
            return lambda *a, **k: timed(spec["name"], fn(*a, **k))
        return timed(spec["name"], fn)

    with _patched(specs, wrap):
        yield


@contextlib.contextmanager
def profiled(label_specs, record_specs, trace: Trace, device):
    """torch.profiler around the block, each label spec's function under a
    record_function of its name, each record spec's ``shape`` reader called
    on its arguments; the profiler's events land in trace."""

    def labelled(spec, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function("tk:" + spec["name"]):
                return fn(*args, **kwargs)
        if spec.get("factory"):
            return lambda *a, **k: labelled(dict(spec, factory=False), fn(*a, **k))
        return run

    def recorded(spec, fn):
        def run(*args, **kwargs):
            trace.records[spec["name"]].append(spec["shape"](*args, **kwargs))
            return fn(*args, **kwargs)
        return run

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with _patched(label_specs, labelled), _patched(record_specs, recorded):
            with torch.profiler.record_function("tk:window"):
                yield
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # kernels, copies and sets; the labels' images on the device
            # timeline (gpu user annotations, named as the labels) are no work
            if not (row[0].startswith("tk:") or getattr(e, "is_user_annotation", bool)()):
                trace.device_events.append(row)
                trace.card_events[e.device_index()].append(row)
        else:
            trace.host_events.append(row)
            if row[0] == "tk:window":
                trace.window_ns = (row[1], row[2])


def busy_and_gaps(trace: Trace, card: Optional[int] = None):
    """(device busy seconds inside the profiled window, [(host label, gap
    seconds)] for each idle gap), the busy time being the union of the
    kernel, copy and set intervals of every card, or of card `card` alone.
    A gap is put down to the innermost host event that spans its middle,
    prefixed by the innermost 'tk:' label there."""
    if trace.window_ns is None:
        return 0.0, []
    w0, w1 = trace.window_ns
    events = trace.device_events if card is None else trace.card_events.get(card, [])
    spans_ = sorted((max(s, w0), min(e, w1)) for _, s, e in events if e > w0 and s < w1)
    busy, gaps, end = 0, [], w0
    for s, e in spans_:
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if w1 > end:
        gaps.append((end, w1))
    host = sorted((r for r in trace.host_events if r[0] != "tk:window"), key=lambda r: r[1])
    named, active, i = [], [], 0
    for g0, g1 in gaps:           # in time order: one sweep over the host events
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][1] <= mid:
            active.append(host[i])
            i += 1
        active = [r for r in active if r[2] >= mid]
        labels = [r for r in active if r[0].startswith("tk:")]
        inner = [r for r in active if not r[0].startswith("tk:")]
        what = max(labels, key=lambda r: r[1])[0][3:] + "/" if labels else ""
        what += max(inner, key=lambda r: r[1])[0] if inner else "python"
        named.append((what, (g1 - g0) / 1e9))
    return busy / 1e9, named
