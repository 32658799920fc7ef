"""The nonsymmetric (convection–diffusion) solve at scale: counterpart of
``tensorkrylov_tpu/experiments/nonsym_scale.py``.

d = 10, n = 16384 convection–diffusion factors shifted by σ for a factor
condition number κ (the reaction term that makes such a mode reachable by a
Krylov method), a rank-1 random right-hand side of unit rows, solved by
Arnoldi (CGS2, the full basis) with the Stenger sinc exp-sum (tmax = 801) to
tol 1e-8, and re-measured by the basis-free CP cross-check. Writes a JSON
artifact with the JAX runner's keys (problem, recipe, result, timing) and
the card's peak memory.

The basis is stored whole, as in the JAX package: restarts would break the
exp-sum residual identity the estimate rests on, and the mode-sharded solve
(``parallel/sharding.py``) is the scaling axis. ``solve`` runs the whole
iteration; ``--host-projected`` runs ``solve_host_projected`` (the Krylov
segments on the device, the projected stage on the host). The cross-check is
the compensated device form on the card and the JAX package's host form on
the CPU, over the exp-sum's active terms (the JAX runner passes all tmax
columns; the zero-weight ones add exact zeros).

On the card:  python -m tensorkrylov_tpu_torch.experiments.nonsym_scale
On the CPU:   python -m tensorkrylov_tpu_torch.experiments.nonsym_scale --cpu --n 512 --kappa 1e3 --kmax 120
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .northstar import _DATA, interpret_cross_check, sigma_for_kappa


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--d", type=int, default=10)
    p.add_argument("--n", type=int, default=16384)
    p.add_argument("--c", type=float, default=10.0, help="convection strength")
    p.add_argument("--kappa", type=float, default=1e4, help="target condition number of the shifted operator")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--kmax", type=int, default=384)
    p.add_argument("--tmax", type=int, default=801)
    p.add_argument("--check-every", type=int, default=16)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    p.add_argument("--host-projected", action="store_true",
                   help="run solve_host_projected (Krylov segments on the device, projected stage on the host)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch.utils.cp import cp_residual_cross_check_device, cp_residual_cross_check_host

    device = torch.device("cpu") if args.cpu else torch.device("cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("nonsym_scale: no CUDA device; pass --cpu to run on the CPU")
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    print("device:", kind, flush=True)

    sigma = sigma_for_kappa(args.n, args.kappa)
    op = tkt.conv_diff(args.d, args.n, c=args.c, shift=sigma, device=device)
    b = tkt.random_rhs(args.d, args.n, seed=args.seed)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)

    cfg = tkt.SolverConfig(kmax=args.kmax, tol=args.tol, orth="arnoldi", tmax=args.tmax,
                           check_every=args.check_every)
    solver = tkt.solve_host_projected if args.host_projected else tkt.solve
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = solver(op, b, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    k = int(res.niterations)
    # the residuals are recorded at the check cadence: take the last finite
    # one up to step k, the check that ended the solve
    hist = res.relative_residual.cpu().numpy()[:k + 1]
    fin = np.flatnonzero(np.isfinite(hist))
    k_rec = int(fin[-1]) if fin.size else k - 1
    rel = float(hist[k_rec])
    rank = int(res.expsum_rank[k_rec])
    print(f"status={int(res.status)} k={k} rel={rel:.3e} rank={rank} {t_solve:.1f}s ({k / t_solve:.1f} it/s)",
          flush=True)

    # only the exp-sum's active terms carry x: a zero weight's column adds exact zeros to the residual's
    # Gram contraction, so the cross-check reads the active columns (rank of tmax = 801)
    act = torch.nonzero(res.x.weights).flatten()
    w, X = res.x.weights[act], res.x.factors[:, :, act]
    b_np = b.numpy().astype(np.float64)
    if device.type == "cuda":
        check = cp_residual_cross_check_device(op, w, X, b)
    else:
        check = cp_residual_cross_check_host(op.bands.numpy().astype(np.float64), op.offsets,
                                             w.numpy().astype(np.float64), X.numpy().astype(np.float64), b_np)
    b_norm = float(np.prod(np.linalg.norm(b_np, axis=1)))
    meas, floor = check.value / b_norm, check.floor / b_norm
    interp = interpret_cross_check(meas, floor, rel, args.tol)
    print(f"cross-check {meas:.3e} (floor {floor:.3e}; {interp})", flush=True)

    out = args.out or os.path.join(_DATA, f"nonsym_scale_d{args.d}_n{args.n}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    artifact = {
        "problem": {"family": "conv_diff + sigma*I", "d": args.d, "n": args.n, "c": args.c, "sigma": sigma,
                    "kappa_target": args.kappa, "tol": args.tol, "seed": args.seed},
        "recipe": {"orth": "arnoldi (CGS2, full basis)", "expsum": "stenger sinc", "tmax": args.tmax,
                   "kmax": args.kmax, "check_every": args.check_every, "solver": solver.__name__,
                   "memory_strategy": "full basis (see module docstring: restarts rejected - they break the "
                                      "exp-sum residual identity; mode sharding is the scaling axis)"},
        "result": {"status": int(res.status), "converged": int(res.status) == 1, "niterations": k,
                   "relative_residual": rel, "expsum_rank": rank, "measured_cp_residual": meas,
                   "cp_residual_floor": floor, "cp_residual_interpretation": interp},
        "timing": {"device": kind, "solve_s": t_solve, "iterations_per_s": k / t_solve,
                   "max_memory_allocated": peak},
    }
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print("saved", out, flush=True)
    return artifact


if __name__ == "__main__":
    main()
