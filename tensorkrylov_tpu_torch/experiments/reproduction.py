"""Paper-reproduction experiment: counterpart of
``tensorkrylov_tpu/experiments/reproduction.py``, the reference's
configuration: SPD d ∈ {5, 10, 50, 100}, n = 200, tol = 1e-9, Laplace factors
with reorthogonalized Lanczos; nonsymmetric: ConvDiff factors with Arnoldi and
a rank-601 sinc quadrature. Identical factors and a replicated RHS, as in the
reference. Results are returned, and written as JSON traces when out_dir is
given.

Run: python -m tensorkrylov_tpu_torch.experiments.reproduction [--dims 5 10] [--n 200] [--cpu] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import torch

from ..convergence import summarize, trim
from ..models.gallery import conv_diff, laplace
from ..solver import solve
from ..system import random_rhs
from ..types import SolverConfig

__all__ = ["run_reproduction"]


def run_reproduction(
    dims: List[int] = (5, 10, 50, 100),
    n: int = 200,
    tol: float = 1e-9,
    nmax: Optional[int] = None,
    symmetric: bool = True,
    seed: int = 1234,
    out_dir: Optional[str] = None,
    verbose: bool = True,
    tmax: int = 601,
    device=None,
):
    """One solve per d in dims on `device`, by default the CUDA device (the
    gallery's default: without a card it raises, naming device="cpu");
    returns {d: summary} and, with out_dir, rewrites
    reproduction_{laplace|convdiff}_n{n}.json after each d (an interrupted
    sweep keeps the finished dimensions)."""
    nmax = nmax or n
    results = {}
    for d in dims:
        if symmetric:
            op = laplace(d, n, device=device)
            # identical factors and RHS rows: the shared-eigh fast path
            cfg = SolverConfig(kmax=nmax, tol=tol, orth="lanczos_reorth", identical_factors=True)
        else:
            op = conv_diff(d, n, device=device)
            # the rank-~400 sinc quadrature is what reaches tol=1e-9
            cfg = SolverConfig(kmax=nmax, tol=tol, orth="arnoldi", tmax=tmax, identical_factors=True)
        b = random_rhs(d, n, seed=seed, device=op.device)
        b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
        t0 = time.perf_counter()
        res = solve(op, b, cfg)
        ni = int(res.niterations)
        if op.device.type == "cuda":
            torch.cuda.synchronize(op.device)
        wall = time.perf_counter() - t0
        traces = trim(res)
        results[d] = {
            "d": d,
            "n": n,
            "tol": tol,
            "status": int(res.status),
            "niterations": ni,
            "wall_s": wall,
            "final_relative_residual": float(traces["relative_residual"][-1]),
            "relative_residual": traces["relative_residual"].tolist(),
            "expsum_rank": traces["expsum_rank"].tolist(),
        }
        if verbose:
            print(f"--- d={d} n={n} {'SPD' if symmetric else 'nonsym'} ({wall:.1f}s, {ni / wall:.1f} it/s)", flush=True)
            print(summarize(res, every=max(ni // 8, 1)), flush=True)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            tag = "laplace" if symmetric else "convdiff"
            path = os.path.join(out_dir, f"reproduction_{tag}_n{n}.json")
            with open(path, "w") as f:
                json.dump(results, f)
            if verbose:
                print("saved", path)
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dims", type=int, nargs="+", default=[5, 10, 50, 100])
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--nmax", type=int, default=None)
    p.add_argument("--nonsym", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    p.add_argument("--out", default=None, help="write the JSON traces into this directory")
    p.add_argument("--tmax", type=int, default=601)
    args = p.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    run_reproduction(args.dims, args.n, args.tol, args.nmax, not args.nonsym, out_dir=args.out, tmax=args.tmax,
                     device="cpu" if args.cpu else "cuda")
