"""Headline benchmark of the port: prints ONE JSON line with the keys of the
JAX package's ``bench.py`` (at the repository root), measured on the CUDA
device.

    python -m tensorkrylov_tpu_torch.bench

What each key measures on the card (d=8 tridiagonal ``laplace`` factors,
n=2^20, f32, unless stated; throughputs count the operator's nonzeros,
d·(3n−2) per apply or step):

- ``xla_scan_gnnz_s``: the per-apply loop u ← c·(A u), one launch of the
  ``banded_spmv`` kernel (``ops/csrc/banded_spmv.cu``) and one scaling per
  apply; two-point slope over m = 200 and 800 applies.
- ``resident_pallas_gnnz_s``: the same m applies through ``spmv_multi_apply``,
  the temporally blocked ``resident_spmv`` kernel (``ops/csrc/resident_spmv.cu``);
  same slope.
- ``value``: the larger of the two; ``vs_baseline``: ``value`` over
  ``cpu_numpy_gnnz_s``, the host's C++ banded SpMV (``native.py``).
- ``solver_iters_per_s_f64``: full ``solve`` iterations per second, d=5,
  n=4096, f64, kmax=64, check_every=8.
- ``solver_loop_xla_gnnz_s`` / ``solver_loop_resident_gnnz_s``: complete
  plain f32 Lanczos steps. The first is this module's own loop, which mirrors
  the JAX bench's ``xla_steps``: the SpMV kernel, torch reductions and
  elementwise updates, a division by β; it is not the solver's step
  (``ops/orth.lanczos_step``), which also tests for a lucky breakdown and
  writes H and b̃. The second is the ``resident_lanczos`` kernel. Slope over
  8→64 and 8→32 steps.
- ``solve_resident_gnnz_s`` / ``solve_xla_segment_gnnz_s``: full
  ``solve_host_projected`` runs with ``step_impl='resident'`` and ``'xla'``
  (plain f32 Lanczos, check_every=8, tol=1e-30); slope over kmax 8→32.
- ``roofline_3350GBps``: the H100's HBM bound (3.35 TB/s) for the per-apply
  stream (3 bands, v and u move every apply: 20 B per element in f32) and for
  bands kept on chip (only v and u move: 8 B).

Times are the best of three runs after a warm-up, each ended by
``torch.cuda.synchronize()``. Before it is timed, each kernel is gated against
its plain version on the measurement's inputs (the SpMV loop and the
multi-apply SpMV over 3 applies, the resident Lanczos kernel over the shorter
step count: the same bits), and each host-projected solve must return a finite
solution. Any failure raises: no number stands in for one that was not
measured. Without a CUDA device the bench exits non-zero.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import native
from .models.gallery import laplace
from .ops.banded import spmv, spmv_reference
from .ops.resident_lanczos import lanczos_resident_steps, lanczos_resident_steps_reference
from .ops.resident_spmv import resident_spmv_plan, spmv_multi_apply, spmv_multi_apply_reference
from .solver import solve, solve_host_projected
from .system import random_rhs
from .types import SolverConfig

__all__ = ["measure", "main", "SPMV_D", "SPMV_N", "HBM_BYTES_PER_S"]

SPMV_D, SPMV_N = 8, 1 << 20  # shared by the measurement and the roofline model
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(fn: Callable[[], object], device: torch.device, reps: int = 3) -> float:
    """Seconds of the fastest of reps runs of fn, after one warm-up run."""
    fn()
    _sync(device)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _gate(what: str, got, ref) -> float:
    """Raise unless the kernel's outputs equal its plain version's bit for
    bit (tensors or tuples of them); return the largest difference, 0.0."""
    pairs = zip(got, ref) if isinstance(got, tuple) else ((got, ref),)
    err = max(float((g - r).abs().max()) for g, r in pairs)
    if err != 0.0:
        raise RuntimeError(f"{what} differs from its plain version by {err}")
    return err


def _slope_gnnz(nnz: int, m1: int, m2: int, dt1: float, dt2: float) -> float:
    """Gnnz/s from the (m2 − m1) slope, which cancels fixed launch costs; when
    the slope is degenerate (dt2 ≤ 1.2·dt1), the total-time rate at m2, as
    the JAX bench does."""
    if dt2 > 1.2 * dt1:
        return nnz * (m2 - m1) / (dt2 - dt1) / 1e9
    return nnz * m2 / dt2 / 1e9


def _spmv_problem(device, d, n):
    op = laplace(d, n, dtype=torch.float32, device=device)
    v = torch.tensor(np.random.default_rng(0).standard_normal((d, n)), dtype=torch.float32, device=device)
    return op, v, 1.0 / (4.0 * (n + 1) ** 2)  # scale ≈ 1/λ_max keeps the applies finite


def bench_spmv(device, d=SPMV_D, n=SPMV_N, iters=200) -> float:
    """The per-apply loop: m launches of the SpMV kernel, each product times
    the scale rounded to f32."""
    op, v, scale = _spmv_problem(device, d, n)
    c = float(torch.tensor(scale, dtype=torch.float32))

    def many(m, apply=spmv):
        x = v
        for _ in range(m):
            x = apply(op, x) * c
        return x

    _gate("the SpMV loop", many(3), many(3, spmv_reference))

    m1, m2 = iters, 4 * iters
    return _slope_gnnz(d * op.nnz_per_factor, m1, m2, _best_of(lambda: many(m1), device),
                       _best_of(lambda: many(m2), device))


def bench_spmv_resident(device, d=SPMV_D, n=SPMV_N, iters=200) -> dict:
    """spmv_multi_apply (the resident_spmv kernel on the card), gated first
    against its plain version: 3 applies must give the same bits."""
    op, v, scale = _spmv_problem(device, d, n)
    err = _gate("the multi-apply SpMV", spmv_multi_apply(op, v, 3, scale),
                spmv_multi_apply_reference(op, v, 3, scale))
    m1, m2 = iters, 4 * iters
    out = {"gnnz": _slope_gnnz(d * op.nnz_per_factor, m1, m2,
                               _best_of(lambda: spmv_multi_apply(op, v, m1, scale), device),
                               _best_of(lambda: spmv_multi_apply(op, v, m2, scale), device)),
           "gate_max_abs_err": err}
    if device.type == "cuda":
        M, T = resident_spmv_plan(op)
        out.update(applies_per_launch=M, tile=T, launches_per_run={m1: -(-m1 // M), m2: -(-m2 // M)})
    return out


def bench_spmv_cpu(d=SPMV_D, n=SPMV_N, iters=10) -> float:
    """Host baseline: the C++ banded SpMV of ``native.py`` (numpy when it
    cannot be built) on this machine's CPU cores, f32."""
    rng = np.random.default_rng(0)
    h2 = np.float32((n + 1) ** 2)
    bands = np.zeros((d, 3, n), np.float32)
    bands[:, 0, 1:] = -h2
    bands[:, 1, :] = 2 * h2
    bands[:, 2, :-1] = -h2
    v = rng.standard_normal((d, n)).astype(np.float32)
    native.banded_spmv(bands, (-1, 0, 1), v)  # build and warm up
    t0 = time.perf_counter()
    x = v
    for _ in range(iters):
        x = native.banded_spmv(bands, (-1, 0, 1), x)
    dt = time.perf_counter() - t0
    return d * (3 * n - 2) * iters / dt / 1e9


def bench_solver_iterations(device, d=5, n=4096, kmax=64) -> float:
    """Full solve iterations per second, f64, check_every=8, tol=1e-30 (so
    that every one of the kmax steps runs)."""
    cfg = SolverConfig(kmax=kmax, tol=1e-30, check_every=8, identical_factors=True)
    op = laplace(d, n, device=device)
    b = random_rhs(d, n, seed=0, device=device)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    solve(op, b, cfg)
    _sync(device)
    t0 = time.perf_counter()
    res = solve(op, b, cfg)
    _sync(device)
    return res.niterations / (time.perf_counter() - t0)


def _unit_start(d, n, device):
    b = np.random.default_rng(0).standard_normal((d, n)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    return torch.tensor(b, device=device)


def bench_solver_loop(device, d=SPMV_D, n=SPMV_N, steps_xla=(8, 64), steps_resident=(8, 32)) -> dict:
    """Complete plain f32 Lanczos steps (SpMV, α and β reductions, updates,
    normalization, the basis-column write): a loop of torch operations around
    the banded_spmv kernel, as the JAX bench's ``xla_steps``, against the
    resident_lanczos kernel, which is gated first against its plain version."""
    op = laplace(d, n, dtype=torch.float32, device=device)
    vp0 = _unit_start(d, n, device)
    vpp0 = torch.zeros_like(vp0)
    beta0 = torch.zeros((d,), dtype=torch.float32, device=device)
    nnz = d * op.nnz_per_factor

    def plain_steps(S):
        V = torch.empty((S, d, n), dtype=torch.float32, device=device)
        vp, vpp, beta = vp0, vpp0, beta0
        for j in range(S):
            u = spmv(op, vp) - beta[:, None] * vpp
            alpha = torch.sum(u * vp, dim=1)
            u = u - alpha[:, None] * vp
            beta = torch.sqrt(torch.sum(u * u, dim=1))
            V[j] = u / beta[:, None]
            vp, vpp = V[j], vp
        return V

    s = steps_resident[0]
    _gate("the resident Lanczos kernel", lanczos_resident_steps(op, vp0, vpp0, beta0, s),
          lanczos_resident_steps_reference(op, vp0, vpp0, beta0, s))

    def rate(fn, steps):
        s1, s2 = steps
        return _slope_gnnz(nnz, s1, s2, _best_of(lambda: fn(s1), device), _best_of(lambda: fn(s2), device))

    return {"xla": rate(plain_steps, steps_xla),
            "resident": rate(lambda S: lanczos_resident_steps(op, vp0, vpp0, beta0, S), steps_resident)}


def bench_solve_host_projected(device, d=SPMV_D, n=SPMV_N, kmaxes=(8, 32)) -> dict:
    """Full solve_host_projected runs (setup, Krylov segments, host projected
    stage, lift of the (d, n, 63) solution) with the resident route and the
    unfused route, slope over kmax. tol=1e-30 runs every step."""
    op = laplace(d, n, dtype=torch.float32, device=device)
    b = random_rhs(d, n, seed=0, device=device)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    nnz = d * op.nnz_per_factor
    out = {}
    for impl in ("resident", "xla"):
        def run(kmax):
            cfg = SolverConfig(kmax=kmax, tol=1e-30, orth="lanczos", basis_dtype=torch.float32, check_every=8,
                               step_impl=impl)
            res = solve_host_projected(op, b, cfg)
            if (res.config.step_impl != impl or res.niterations != min(kmax, n)
                    or not bool(torch.isfinite(res.x.factors).all())):
                raise RuntimeError(f"solve_host_projected({impl}, kmax={kmax}) took step_impl "
                                   f"{res.config.step_impl!r} and {res.niterations} steps, finite solution: "
                                   f"{bool(torch.isfinite(res.x.factors).all())}")
            return res
        k1, k2 = kmaxes
        out[impl] = _slope_gnnz(nnz, k1, k2, _best_of(lambda: run(k1), device), _best_of(lambda: run(k2), device))
    return out


def _nvidia_smi() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def measure(device="cuda", d=SPMV_D, n=SPMV_N, iters=200, cpu_iters=10, solver=(5, 4096, 64),
            loop_steps=((8, 64), (8, 32)), solve_kmaxes=(8, 32)) -> dict:
    """Run every measurement on device and return the bench's JSON object.
    The defaults are the bench's shapes; smaller ones serve the CPU tests."""
    device = torch.device(device)
    gnnz_xla = bench_spmv(device, d, n, iters)
    resident = bench_spmv_resident(device, d, n, iters)
    gnnz_res = resident["gnnz"]
    gnnz = max(gnnz_xla, gnnz_res)
    cpu_gnnz = bench_spmv_cpu(d, n, cpu_iters)
    iters_per_s = bench_solver_iterations(device, *solver)
    loop = bench_solver_loop(device, d, n, *loop_steps)
    host = bench_solve_host_projected(device, d, n, solve_kmaxes)

    elem = 4  # f32, the measurement's dtype
    nnz = d * (3 * n - 2)
    stream = nnz / ((5 * d * n * elem) / HBM_BYTES_PER_S) / 1e9
    bands_resident = nnz / ((2 * d * n * elem) / HBM_BYTES_PER_S) / 1e9
    extra = {
        "platform": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "nvidia_smi": _nvidia_smi() if device.type == "cuda" else None,
        "xla_scan_gnnz_s": gnnz_xla,
        "resident_pallas_gnnz_s": gnnz_res,
        "cpu_numpy_gnnz_s": cpu_gnnz,
        "cpu_baseline_runtime": native.runtime(),
        "solver_iters_per_s_f64": iters_per_s,
        "solver_loop_xla_gnnz_s": loop["xla"],
        "solver_loop_resident_gnnz_s": loop["resident"],
        "solve_resident_gnnz_s": host["resident"],
        "solve_xla_segment_gnnz_s": host["xla"],
        "spmv_config": f"d={d} tridiag n={n} f32",
        "resident_spmv": {k: v for k, v in resident.items() if k != "gnnz"},
        "roofline_3350GBps": {
            "stream_gnnz_s": stream,
            "bands_resident_gnnz_s": bands_resident,
            "fraction_of_stream": gnnz / stream,
        },
    }
    return {"metric": "factor_spmv_throughput", "value": gnnz, "unit": "Gnnz/s", "vs_baseline": gnnz / cpu_gnnz,
            "extra": extra}


def main(argv=None) -> int:
    if argv:
        raise SystemExit(f"tensorkrylov_tpu_torch.bench takes no arguments, got {argv}")
    if not torch.cuda.is_available():
        raise SystemExit("tensorkrylov_tpu_torch.bench: no CUDA device (the bench measures the card only)")
    print(json.dumps(measure("cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
