"""Profiling hooks: counterpart of ``tensorkrylov_tpu/utils/profiling.py``.

A context manager around ``torch.profiler`` for device traces that
TensorBoard or Perfetto read, and a wall-clock timer. The JAX package's
``compiled_cost`` reads XLA's cost analysis of a jitted call; eager PyTorch
has no compiled program to ask, so it raises here.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["device_trace", "timed_block", "compiled_cost"]


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a CPU and, where there is a card, CUDA trace into logdir as a
    Chrome trace (``<logdir>/trace_<pid>_<n>.json``, which Perfetto and
    TensorBoard's profile plugin open):

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


@contextlib.contextmanager
def timed_block(label: str, results: Optional[dict] = None):
    """Wall-clock a block. It does not wait for the card's queued work: a
    caller timing device work synchronizes inside the block."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = dt
        else:
            print(f"[{label}] {dt:.4f}s")


def compiled_cost(fn, *args, static_argnames=()):
    """XLA's FLOP and byte estimates of a jitted call have no counterpart."""
    raise NotImplementedError("compiled_cost reads XLA's cost analysis of a compiled program, which eager PyTorch "
                              "does not make; time the call with timed_block or trace it with device_trace "
                              "(ROADMAP.md Queue 1, #10)")
