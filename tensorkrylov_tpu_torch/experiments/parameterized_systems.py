"""Condition-number parameter sweeps: counterpart of
``tensorkrylov_tpu/experiments/parameterized_systems.py``.

SPD factors (1/h²)·tridiag(−1, α, −1), parameterized by the diagonal α (κ
grows as α → 2), and nonsymmetric convection–diffusion factors with a
parameterized first superdiagonal β.

Run: python -m tensorkrylov_tpu_torch.experiments.parameterized_systems --alpha 2.2 --beta -4.0 [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..convergence import trim
from ..models.gallery import _banded_operator, bands_to_dense
from ..solver import solve
from ..system import random_rhs
from ..types import KroneckerSumOperator, SolverConfig

__all__ = ["parameterized_spd", "parameterized_nonsym", "parameterized_cond", "parameterized_experiment"]


def parameterized_spd(d: int, n: int, alpha: float, dtype=torch.float64, device=None) -> KroneckerSumOperator:
    """(1/h²)·tridiag(−1, α, −1)."""
    h2inv = float((n + 1) ** 2)
    return _banded_operator({-1: -h2inv, 0: alpha * h2inv, 1: -h2inv}, d, n, dtype, True, device)


def parameterized_nonsym(d: int, n: int, beta: float, c: float = 10.0, dtype=torch.float64,
                         device=None) -> KroneckerSumOperator:
    """The Laplacian + (c/4h)·diags(1 @ −1, 3 @ 0, β @ +1, 1 @ +2)."""
    h = 1.0 / (n + 1)
    h2inv = 1.0 / h**2
    cv = c / (4.0 * h)
    return _banded_operator({-1: -h2inv + cv, 0: 2.0 * h2inv + 3.0 * cv, 1: -h2inv + beta * cv, 2: cv},
                            d, n, dtype, False, device)


def parameterized_cond(n: int, alpha: float) -> float:
    """κ of one SPD factor (a host eigvalsh)."""
    ev = np.linalg.eigvalsh(bands_to_dense(parameterized_spd(1, n, alpha, device="cpu"))[0])
    return float(ev[-1] / ev[0])


def _summary(res, t0, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tr = trim(res)
    return {
        "status": int(res.status),
        "niterations": int(res.niterations),
        "wall_s": time.perf_counter() - t0,
        "final_relative_residual": float(tr["relative_residual"][-1]),
        "relative_residual": tr["relative_residual"].tolist(),
    }


def parameterized_experiment(alpha: float = 2.2, beta: float = -5.0, dims: Sequence[int] = (5, 10, 50, 100),
                             n: int = 200, tol: float = 1e-9, nmax: Optional[int] = None, seed: int = 1234,
                             verbose: bool = True, device=None):
    """Per d, the SPD solve (reorthogonalized Lanczos) and the nonsymmetric one
    (Arnoldi, the rank-601 sinc rule, identical factors) on `device`, by
    default the CUDA device."""
    results = {"alpha": alpha, "beta": beta, "spd": {}, "nonsym": {}}
    for d in dims:
        op = parameterized_spd(d, n, alpha, device=device)
        b = random_rhs(d, n, seed=seed, device=op.device)
        b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
        t0 = time.perf_counter()
        res = solve(op, b, SolverConfig(kmax=nmax or n, tol=tol, orth="lanczos_reorth"))
        results["spd"][d] = _summary(res, t0, op.device)

        op2 = parameterized_nonsym(d, n, beta, device=device)
        t0 = time.perf_counter()
        res2 = solve(op2, b, SolverConfig(kmax=nmax or n, tol=tol, orth="arnoldi", tmax=601, identical_factors=True))
        results["nonsym"][d] = _summary(res2, t0, op2.device)
        if verbose:
            print(f"d={d}: spd final={results['spd'][d]['final_relative_residual']:.2e} "
                  f"nonsym final={results['nonsym'][d]['final_relative_residual']:.2e}")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--alpha", type=float, default=2.2)
    p.add_argument("--beta", type=float, default=-5.0)
    p.add_argument("--dims", type=int, nargs="+", default=[5, 10])
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    p.add_argument("--out", default=None, help="write the JSON traces into this directory")
    args = p.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    results = parameterized_experiment(args.alpha, args.beta, args.dims, args.n, args.tol,
                                       device="cpu" if args.cpu else "cuda")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"parameterized_a{args.alpha}_b{args.beta}.json")
        with open(path, "w") as f:
            json.dump(results, f)
        print("saved", path)
