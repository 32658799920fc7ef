"""Config 4: a rank-R tensor-product RHS at scale through the block Krylov
solvers: counterpart of ``tensorkrylov_tpu/experiments/config4_block.py``.

reaction_diffusion(d=10, n) with σ for a factor κ = 1e4, B (R=4, d, n) of
unit rows from the seed, tol 1e-8. Runs solve_block (one shared block Krylov
space per factor), or with --recorded solve_block_recorded (the
noise-recording recurrence and its certificate; --m composes per-factor
deflation), then the separable comparison solve_multi_rhs (R rank-1 solves),
and writes a JSON artifact: matvecs, wall s, the estimates, the certificate
and the basis-free cross-check of each.

On the card:  python -m tensorkrylov_tpu_torch.experiments.config4_block --recorded --m 512 --n 10240
On the CPU:   python -m tensorkrylov_tpu_torch.experiments.config4_block --cpu --n 512 --kappa 1e3 --kmax 120
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
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument("--kappa", type=float, default=1e4)
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--kmax", type=int, default=360, help="block iterations")
    p.add_argument("--check-every", type=int, default=8, help="residual-evaluation cadence of solve_block")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    p.add_argument("--skip-multi", action="store_true", help="skip the solve_multi_rhs comparison")
    p.add_argument("--recorded", action="store_true",
                   help="solve_block_recorded: the noise-recording block recurrence and its certificate")
    p.add_argument("--final", default="auto", choices=["auto", "host", "device"],
                   help="(--recorded) where x is assembled and cross-checked ('auto': the operator's device)")
    p.add_argument("--m", type=int, default=0, help="(--recorded) per-factor deflation rank")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch.utils.cp import cp_residual_cross_check_device

    device = torch.device("cpu") if args.cpu else torch.device("cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("config4_block: no CUDA device; pass --cpu to run on the CPU")
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    print("device:", kind, flush=True)

    sigma = sigma_for_kappa(args.n, args.kappa)
    op = tkt.reaction_diffusion(args.d, args.n, sigma=sigma, device=device)
    B_np = np.random.default_rng(args.seed).standard_normal((args.rank, args.d, args.n))
    B_np /= np.linalg.norm(B_np, axis=2, keepdims=True)
    B = torch.tensor(B_np, device=device)
    cfg = tkt.SolverConfig(kmax=args.kmax, tol=args.tol, check_every=args.check_every, orth="lanczos_reorth",
                           spectral_source="H")
    Gb = np.einsum("rsn,qsn->srq", B_np, B_np).astype(np.longdouble)
    b_norm = float(np.sqrt(max(float(np.prod(Gb, axis=0).sum()), 0.0)))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def evidence(x, label):
        check = cp_residual_cross_check_device(op, x.weights, x.factors, B)
        meas, floor = check.value / b_norm, check.floor / b_norm
        print(f"{label}: cross-check {meas:.3e} (floor {floor:.3e})", flush=True)
        return meas, floor

    cert = {}
    sync()
    t0 = time.perf_counter()
    if args.recorded:
        # the exact joint λ_min: σ shifts the analytic 1-D Laplace spectrum
        lmin_1d = 4.0 * (args.n + 1) ** 2 * np.sin(np.pi / (2 * (args.n + 1))) ** 2
        lam_min = args.d * (sigma + lmin_1d)
        rb = tkt.solve_block_recorded(op, B, cfg, lam_min=lam_min, final=args.final, m=args.m, verbose=True)
        sync()
        t_block = time.perf_counter() - t0
        k, est = rb.niterations, rb.relative_residual[-1]
        meas, floor = rb.measured_cp_residual, rb.cp_residual_floor
        print(f"block(recorded): status={rb.status} k={k} est={est:.3e} certified {rb.certified_bound[-1]:.3e} "
              f"{t_block:.1f}s", flush=True)
        cert = {"certified_bound": rb.certified_bound, "checkpoints": rb.checkpoints, "expsum_sup": rb.expsum_sup,
                "sweep_overlap": rb.sweep_overlap, "gram_deviation": rb.gram_deviation,
                "relation_dev_term": rb.relation_dev_term, "relation_eta_term": rb.relation_eta_term,
                "relation_r2_term": rb.relation_r2_term, "perturbation_rho": rb.perturbation_rho,
                "eft_eps_measured": rb.eft_eps_measured, "lam_min_exact": lam_min, "deflation_m": args.m}
    else:
        rb = tkt.solve_block(op, B, cfg)
        sync()
        t_block = time.perf_counter() - t0
        k = int(rb.niterations)
        est = float(rb.relative_residual[k])
        print(f"block: status={rb.status} k={k} est={est:.3e} {t_block:.1f}s", flush=True)
        meas, floor = evidence(rb.x, "block")
    mv_block = k * args.rank * args.d
    out = {
        "problem": {"family": "reaction_diffusion", "d": args.d, "n": args.n, "sigma": sigma, "kappa": args.kappa,
                    "rank": args.rank, "tol": args.tol, "seed": args.seed},
        "block": {"solver": "solve_block_recorded" if args.recorded else "solve_block", "status": int(rb.status),
                  "block_iterations": k, "matvecs": mv_block, "estimate": est, "measured_cp_residual": meas,
                  "cp_residual_floor": floor,
                  "interpretation": interpret_cross_check(meas, floor, cert.get("certified_bound", [None])[-1],
                                                          args.tol),
                  "wall_s": t_block, **cert},
        "device": kind,
    }
    if not args.skip_multi:
        sync()
        t0 = time.perf_counter()
        xm, rm = tkt.solve_multi_rhs(op, B, cfg)
        sync()
        t_multi = time.perf_counter() - t0
        iters = rm.niterations.cpu().numpy().astype(int)
        mv_multi = int(iters.sum()) * args.d
        print(f"multi: iterations={iters.tolist()} ({mv_multi} matvecs) {t_multi:.1f}s", flush=True)
        meas_m, floor_m = evidence(xm, "multi")
        out["multi_rhs"] = {"status": rm.status.cpu().numpy().astype(int).tolist(), "iterations": iters.tolist(),
                            "matvecs": mv_multi, "measured_cp_residual": meas_m, "cp_residual_floor": floor_m,
                            "wall_s": t_multi}
        out["block_vs_multi_matvec_ratio"] = mv_block / max(mv_multi, 1)

    path = args.out or os.path.join(_DATA, f"config4_block_d{args.d}_n{args.n}_r{args.rank}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("saved", path, flush=True)
    return out


if __name__ == "__main__":
    main()
