"""Synthetic-spectrum experiments: counterpart of
``tensorkrylov_tpu/experiments/eigenvalue_distribution.py``.

How Krylov convergence depends on the spectrum of the factors, on diagonal
(eigval_matrix) operators with prescribed eigenvalue families:

  * clusterzero: λ_j = j²/n²          (cluster at 0, κ = n²)
  * clusterone : λ_1 = 1/n², λ_j = log j / log n  (cluster at 1)
  * uniform    : λ_j equispaced on an interval, factor s shifted by (s−1)·Δ/d
                 so that the d factors interleave

with the perturbed variant (factor s shifted by (s+1)·ε) and the explicit
Kronecker-sum spectrum for histograms.

Run: python -m tensorkrylov_tpu_torch.experiments.eigenvalue_distribution [--dims 5 10] [--n 200] [--cpu]
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..convergence import trim
from ..models.gallery import eigval_matrix
from ..solver import solve
from ..system import random_rhs
from ..types import SolverConfig

__all__ = [
    "clusterzero",
    "clusterone",
    "uniform_eigenvalues",
    "perturb_eigenvalues",
    "kronsum_spectrum",
    "kronsum_spectrum_multiset",
    "eigenvalue_experiment",
    "uniform_experiment",
]


def clusterzero(n: int) -> np.ndarray:
    """λ_j = j²/n²."""
    j = np.arange(1, n + 1, dtype=np.float64)
    return j**2 / n**2


def clusterone(n: int) -> np.ndarray:
    """λ_1 = 1/n², λ_j = log j/log n."""
    vals = np.log(np.arange(1, n + 1, dtype=np.float64)) / np.log(n)
    vals[0] = 1.0 / n**2
    return vals


def uniform_eigenvalues(n: int, d: int, interval: Tuple[float, float]) -> np.ndarray:
    """(d, n) interleaved uniform spectra: factor s shifted by s·Δ/d."""
    base = np.linspace(interval[0], interval[1], n)
    step = base[1] - base[0]
    return np.stack([base + (s * step / d) for s in range(d)])


def perturb_eigenvalues(eigenvalues, d: int, eps: float) -> np.ndarray:
    """(d, n): factor s gets λ + (s+1)·ε."""
    ev = np.asarray(eigenvalues, dtype=np.float64)
    return np.stack([ev + (s + 1) * eps for s in range(d)])


def kronsum_spectrum_multiset(eigenvalues, d: int):
    """The distinct Kronecker-sum eigenvalues of d identical factors as
    (values, multiplicities): C(n+d-1, d) entries instead of n^d."""
    ev = np.asarray(eigenvalues, dtype=np.float64)
    values, counts = [], []
    for combo in itertools.combinations_with_replacement(range(len(ev)), d):
        values.append(ev[list(combo)].sum())
        # multiplicity = the multinomial coefficient d! / Π m_i!
        mult = math.factorial(d)
        for _, g in itertools.groupby(combo):
            mult //= math.factorial(len(list(g)))
        counts.append(mult)
    order = np.argsort(values)
    return np.asarray(values)[order], np.asarray(counts)[order]


def kronsum_spectrum(per_factor: np.ndarray, limit: int = 2_000_000) -> np.ndarray:
    """The explicit spectrum of the Kronecker sum, all Σ_s λ^{(s)}_{i_s}
    (n^d values; histograms only)."""
    d, n = per_factor.shape
    if n**d > limit:
        raise ValueError(f"n^d = {n**d} exceeds limit {limit}")
    total = np.zeros((1,))
    for s in range(d):
        total = (total[:, None] + per_factor[s][None, :]).reshape(-1)
    return total


def _run_family(name, eigenvalues_fn, dims, n, tol, nmax, seed, verbose, device):
    out = {}
    for d in dims:
        ev = eigenvalues_fn(d)
        op = eigval_matrix(ev, d=None if ev.ndim == 2 else d, device=device)
        b = random_rhs(d, n, seed=seed, device=op.device)
        b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
        cfg = SolverConfig(kmax=nmax or n, tol=tol, orth="lanczos_reorth")
        t0 = time.perf_counter()
        res = solve(op, b, cfg)
        ni = int(res.niterations)
        if op.device.type == "cuda":
            torch.cuda.synchronize(op.device)
        wall = time.perf_counter() - t0
        tr = trim(res)
        out[d] = {
            "status": int(res.status),
            "niterations": ni,
            "wall_s": wall,
            "final_relative_residual": float(tr["relative_residual"][-1]),
            "relative_residual": tr["relative_residual"].tolist(),
        }
        if verbose:
            print(f"{name} d={d}: status={int(res.status)} niter={ni} "
                  f"final={out[d]['final_relative_residual']:.2e} ({wall:.1f}s)")
    return out


def eigenvalue_experiment(dims: Sequence[int] = (5, 10, 50, 100), n: int = 200, tol: float = 1e-9,
                          nmax: Optional[int] = None, eps: float = 0.0, seed: int = 1234, verbose: bool = True,
                          device=None):
    """The clusterzero and clusterone families, optionally perturbed per
    factor, one solve per d on `device` (by default the CUDA device)."""
    results = {}
    for name, fam in (("clusterzero", clusterzero), ("clusterone", clusterone)):
        base = fam(n)

        def ev_fn(d, base=base):
            return perturb_eigenvalues(base, d, eps) if eps else base

        results[name] = _run_family(name, ev_fn, dims, n, tol, nmax, seed, verbose, device)
    return results


def uniform_experiment(dims: Sequence[int] = (5, 10, 50, 100), n: int = 200,
                       interval: Tuple[float, float] = (1.0, 100.0), tol: float = 1e-9, nmax: Optional[int] = None,
                       seed: int = 1234, verbose: bool = True, device=None):
    """Interleaved uniform spectra, one solve per d on `device`."""
    return {"uniform": _run_family("uniform", lambda d: uniform_eigenvalues(n, d, interval), dims, n, tol, nmax, seed,
                                   verbose, device)}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dims", type=int, nargs="+", default=[5, 10, 50, 100])
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--eps", type=float, default=0.0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    p.add_argument("--out", default=None, help="write the JSON traces into this directory")
    args = p.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    dev = "cpu" if args.cpu else "cuda"
    results = eigenvalue_experiment(args.dims, args.n, args.tol, eps=args.eps, device=dev)
    results.update(uniform_experiment(args.dims, args.n, device=dev))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"eigenvalue_distribution_n{args.n}.json")
        with open(path, "w") as f:
            json.dump(results, f)
        print("saved", path)
