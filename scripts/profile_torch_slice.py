#!/usr/bin/env python3
"""Where the time of the PyTorch port's slice solve goes, on one CUDA card.

Run from the repository root:
  python3 scripts/profile_torch_slice.py [--n 131072] [--config default fused host_resident host_xla]

For each config it solves reaction_diffusion(d=10, n, σ) with σ chosen for a
factor condition number κ = 1e2 (the problem of chip_smoke.py's slice phase),
with kmax=200, tol=1e-8, and prints one JSON line per measurement. 'default'
and 'fused' run solve() with an f64 basis; 'host_resident' and 'host_xla' run
solve_host_projected with plain f32 Lanczos, check_every=8, and the resident
multi-step kernel or the unfused step (chip_smoke.py's host_projected phase):

  cold    — the first solve of the process (kernel build excluded);
  warm    — a second solve, host clock, synchronized at the end;
  layers  — a third solve with a synchronize around every Krylov step or
            segment (lanczos_step; _resident_segment_update or _steps_segment)
            and every projected_step call, and the seconds spent in each;
  profile — a fourth solve under torch.profiler: the host wall time of that
            solve and, from the same trace, the device busy time (the union of
            kernel, memcpy and memset intervals), so the idle share is
            1 − busy / wall over one window; then the kernels by self device
            time. The profiler adds host overhead, so this idle share is an
            upper bound on the unprofiled one;
  eigh    — torch.linalg.eigh of the padded (10, K, K) projected matrices,
            alone, on the card (CUDA events) and on the host CPU (host clock).

The card's name and power limit (nvidia-smi) come first. The Chrome trace of
each profiled solve is written to build/profile/. Without a CUDA device the
script exits with code 1.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import tensorkrylov_tpu_torch as tkt  # noqa: E402
from tensorkrylov_tpu_torch import solver  # noqa: E402
from tensorkrylov_tpu_torch.ops import _build  # noqa: E402

_HOST = dict(kmax=200, tol=1e-8, orth="lanczos", basis_dtype=torch.float32, check_every=8)
CONFIGS = {  # name: (entry, config fields, the solver functions the layer split times)
    "default": ("solve", dict(kmax=200, tol=1e-8), ("lanczos_step", "projected_step")),
    "fused": ("solve", dict(kmax=200, tol=1e-8, orth="lanczos_reorth_auto", step_impl="fused"),
              ("lanczos_step", "projected_step")),
    "host_resident": ("solve_host_projected", dict(_HOST, step_impl="resident"),
                      ("_resident_segment_update", "projected_step")),
    "host_xla": ("solve_host_projected", dict(_HOST, step_impl="xla"), ("_steps_segment", "projected_step")),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def emit(what, **fields):
    print(json.dumps({"what": what, **fields}), flush=True)


def sigma_for_kappa(n, kappa):
    """Diagonal shift σ that gives a Laplacian factor the condition number κ."""
    lmax = 4.0 * (n + 1) ** 2 * np.sin(n * np.pi / (2 * (n + 1))) ** 2
    lmin = 4.0 * (n + 1) ** 2 * np.sin(np.pi / (2 * (n + 1))) ** 2
    return float((lmax - kappa * lmin) / (kappa - 1.0))


def timed_solve(op, b, config, entry):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = getattr(tkt, entry)(op, b, config)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def layer_split(op, b, config, entry, layers):
    """Seconds in each of the solver functions named in layers, each call synchronized."""
    spent = dict.fromkeys(layers, 0.0)
    calls = dict.fromkeys(spent, 0)
    originals = {name: getattr(solver, name) for name in spent}

    def timed(name):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return run

    for name in spent:
        setattr(solver, name, timed(name))
    try:
        res, wall = timed_solve(op, b, config, entry)
    finally:
        for name, fn in originals.items():
            setattr(solver, name, fn)
    return res, wall, spent, calls


def busy_us(trace_path):
    """Union of the device intervals of a Chrome trace, in µs, and their count."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    total, end = 0.0, -float("inf")
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total, len(spans)


def profiled(op, b, config, entry, trace_path):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res, wall = timed_solve(op, b, config, entry)
    prof.export_chrome_trace(trace_path)
    busy, spans = busy_us(trace_path)
    rows = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total, reverse=True)
    top = [dict(name=e.key[:90], self_device_ms=e.self_device_time_total / 1e3, calls=e.count)
           for e in rows[:15] if e.self_device_time_total > 0]
    return res, wall, busy / 1e6, spans, top


def eigh_times(d, K, reps=10):
    """ms per torch.linalg.eigh of a (d, K, K) f64 batch: on the card, on the host CPU."""
    A = torch.randn((d, K, K), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    A = A + A.transpose(1, 2)
    Ac = A.cuda()
    for _ in range(3):
        torch.linalg.eigh(Ac)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        torch.linalg.eigh(Ac)
    end.record()
    end.synchronize()
    card = start.elapsed_time(end) / reps
    torch.linalg.eigh(A)
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.linalg.eigh(A)
    return card, (time.perf_counter() - t0) / reps * 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--config", nargs="+", choices=sorted(CONFIGS), default=list(CONFIGS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)
    emit("device", name=torch.cuda.get_device_name(0), torch=torch.__version__, cuda=torch.version.cuda)
    _build.kernels()

    dev = torch.device("cuda")
    d, n = 10, args.n
    op = tkt.reaction_diffusion(d, n, sigma_for_kappa(n, 1e2), device=dev)
    b = tkt.random_rhs(d, n, seed=1234, device=dev)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    trace_dir = os.path.join(REPO, "build", "profile")
    os.makedirs(trace_dir, exist_ok=True)
    for name in args.config:
        entry, fields, layers = CONFIGS[name]
        config = tkt.SolverConfig(**fields)
        res, wall = timed_solve(op, b, config, entry)
        k = res.niterations
        emit("cold", config=name, d=d, n=n, status=res.status, niterations=k, wall_s=wall, its=k / wall,
             step_impl=res.config.step_impl)
        res, wall = timed_solve(op, b, config, entry)
        emit("warm", config=name, niterations=res.niterations, wall_s=wall, its=res.niterations / wall)
        res, wall, spent, calls = layer_split(op, b, config, entry, layers)
        emit("layers", config=name, wall_s=wall, spent_s=spent, calls=calls,
             share={k_: v / wall for k_, v in spent.items()})
        trace = os.path.join(trace_dir, f"profile_torch_slice_{name}_n{n}.json")
        res, wall, busy, spans, top = profiled(op, b, config, entry, trace)
        emit("profile", config=name, niterations=res.niterations, wall_s=wall, device_busy_s=busy,
             idle_share=1.0 - busy / wall, device_spans=spans, device_spans_per_step=spans / res.niterations,
             trace=os.path.relpath(trace, REPO), top_self_device=top)
    card_ms, cpu_ms = eigh_times(d, CONFIGS["default"][1]["kmax"] + 1)
    emit("eigh", shape=[d, 201, 201], dtype="float64", card_ms=card_ms, host_cpu_ms=cpu_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
