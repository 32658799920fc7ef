"""The flagship north-star solve: counterpart of
``tensorkrylov_tpu/experiments/northstar.py``.

d = 10, n = 131072 reaction–diffusion Kronecker sum (σ for κ = 1e6 per
factor), a rank-1 random right-hand side of unit rows, solved to a certified
1e-8 relative residual with per-factor spectral deflation (``deflate.py``).
Writes a JSON artifact with the per-checkpoint trace, the certificate and the
timings.

On the card:  python -m tensorkrylov_tpu_torch.experiments.northstar --m 2048 --checkpoints 384 448 512
              (add --storage df64 --final device for the recorded-relation certificate, the TPU's recipe)
On the CPU:   python -m tensorkrylov_tpu_torch.experiments.northstar --cpu --n 4096 --m 96

The deflation basis is cached under the repository's build/ directory, keyed
by (n, m, σ), and so is the state of a twopass or df64 solve (keyed by
storage, n, m, kmax): a solve finds its cache and resumes. --advance-budget N
runs at most N steps past the cache, saves and exits without an evaluation
(a bounded leg); --save-every N saves within a checkpoint segment.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir, "build")
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def interpret_cross_check(measured, floor, certified_bound, tol):
    """Verdict on the basis-free cross-check against the certificate; a
    measurement above the certified bound is a contradiction, never a
    confirmation.

    Returns one of:
      '<= floor ...'        — the measurement is at its own validity floor
      'above floor: ...'    — above the floor, at or below the bound
      'above certified bound but within tol ...'
      '... CONTRADICTED ...' — above both bound and tol: trust the
                              measurement, not the bound
    """
    if measured is None:
        return None
    floor = floor or 0.0
    if measured <= floor:
        return ("<= floor (measurement floored by sqrt(eps64*Gram mass); "
                "says residual <= floor, nothing finer)")
    if certified_bound is not None and measured > certified_bound:
        if measured > tol:
            return ("above floor AND above certified bound: certificate "
                    "CONTRADICTED - the bound's basis-orthonormality/"
                    "working-precision condition failed; true residual is "
                    "the measured value")
        return ("above certified bound but within tol: certificate slack "
                "exceeded while the solve still meets the target")
    if measured > tol:
        return ("above floor AND above tol: the estimate is NOT confirmed - "
                "true residual is the measured value (estimate floored by "
                "working-precision noise)")
    return "above floor: independent basis-free confirmation"


def sigma_for_kappa(n: int, kappa: float) -> float:
    """Diagonal shift σ that gives a 1-D Dirichlet Laplacian factor the
    condition number κ."""
    lmax = 4.0 * (n + 1) ** 2 * np.sin(n * np.pi / (2 * (n + 1))) ** 2
    lmin = 4.0 * (n + 1) ** 2 * np.sin(np.pi / (2 * (n + 1))) ** 2
    return float((lmax - kappa * lmin) / (kappa - 1.0))


def load_or_make_basis(tkt, op, m: int, path):
    """The deflation basis from the npz at `path`, or computed and saved
    there (path None: computed, not saved). Returns (basis, loaded)."""
    if path and os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return tkt.DeflationBasis(z["U"], z["lam"]), True
    basis = tkt.deflation_basis(op, m)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(tmp, U=basis.U, lam=basis.lam)
        os.replace(tmp, path)
    return basis, False


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--d", type=int, default=10)
    p.add_argument("--n", type=int, default=131072)
    p.add_argument("--m", type=int, default=1024, help="deflation rank")
    p.add_argument("--kappa", type=float, default=1e6)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--kmax", type=int, default=512)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--orth", default="lanczos_reorth_auto",
                   choices=["lanczos", "lanczos_reorth", "lanczos_reorth_auto"])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    p.add_argument("--eigh-impl", default="auto", choices=["auto", "dense", "tridiag_mixed", "host"])
    p.add_argument("--checkpoints", type=int, nargs="+", default=None,
                   help="explicit certificate checkpoints (default: geometric from 32)")
    p.add_argument("--no-certify", action="store_true")
    p.add_argument("--storage", default="auto", choices=["auto", "full", "twopass", "segmented", "df64"])
    p.add_argument("--sweep-every", type=int, default=1, help="df64: the recorded sweep's stride (warns when > 1)")
    p.add_argument("--project-every", type=int, default=1,
                   help="run the U-projection GEMM every p-th Lanczos step (the leak is measured)")
    p.add_argument("--final", default="auto", choices=["auto", "host", "device"],
                   help="df64: where x is assembled and cross-checked ('auto': the card when the "
                        "operator is on it, else the host)")
    p.add_argument("--advance-budget", type=int, default=None,
                   help="df64: advance at most N steps past the resumed cache, save, and exit")
    p.add_argument("--save-every", type=int, default=0, help="df64: save the state every N steps within a segment")
    p.add_argument("--no-state-save", action="store_true", help="use --state-cache for resume only")
    p.add_argument("--state-cache", default="auto",
                   help="npz path of the twopass or df64 recurrence state ('auto': under build/, keyed by "
                        "storage/n/m/kmax; 'none' disables)")
    p.add_argument("--basis-cache", default=None,
                   help="npz path of the deflation basis (default: under build/, keyed by n/m/sigma; "
                        "'none' disables)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch.deflate import _resolve_eigh_impl

    device = torch.device("cpu") if args.cpu else torch.device("cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("northstar: no CUDA device; pass --cpu to run on the CPU")
    kind = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    print("device:", kind, flush=True)

    sigma = sigma_for_kappa(args.n, args.kappa)
    t0 = time.perf_counter()
    op = tkt.reaction_diffusion(args.d, args.n, sigma=sigma, device=device)
    b = tkt.random_rhs(args.d, args.n, seed=args.seed)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)

    t_setup0 = time.perf_counter()
    cache = args.basis_cache or os.path.join(_BUILD, f"tk_deflation_n{args.n}_m{args.m}_s{sigma:.3e}.npz")
    basis, loaded = load_or_make_basis(tkt, op, args.m, None if cache == "none" else cache)
    t_setup = time.perf_counter() - t_setup0
    print(f"deflation setup (m={args.m}): {t_setup:.1f}s" + (f" (loaded from {cache})" if loaded else ""),
          flush=True)

    cfg = tkt.SolverConfig(kmax=args.kmax, tol=args.tol, orth=args.orth, eigh_impl=args.eigh_impl)
    storage = "full" if args.storage == "auto" else args.storage
    state_cache = args.state_cache
    if state_cache == "auto":
        state_cache = (os.path.join(_BUILD, f"tk_ns_state_{storage}_n{args.n}_m{args.m}_k{args.kmax}.npz")
                       if storage in ("twopass", "df64") else None)
    elif state_cache == "none":
        state_cache = None
    if state_cache:
        os.makedirs(os.path.dirname(os.path.abspath(state_cache)), exist_ok=True)
        print("state cache:", state_cache, "(resuming)" if os.path.exists(state_cache) else "(fresh)", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_solve0 = time.perf_counter()
    res = tkt.solve_deflated(op, b, cfg, basis=basis, certify=not args.no_certify, checkpoints=args.checkpoints,
                             state_cache=state_cache, project_every=args.project_every, storage=args.storage,
                             sweep_every=args.sweep_every, final=args.final, save_state=not args.no_state_save,
                             save_every=args.save_every, advance_budget=args.advance_budget, verbose=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_solve = time.perf_counter() - t_solve0
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    if res.x is None:
        print(f"bounded leg: state saved at k={res.niterations} ({t_solve:.1f}s); no evaluation this run", flush=True)
        return {"status": res.status, "niterations": res.niterations, "state_cache": state_cache}

    print(f"status={res.status} k={res.niterations} (+{res.m} deflated) rank={res.expsum_rank}", flush=True)
    print("checkpoints:", res.checkpoints, flush=True)
    print("estimate   :", [f"{r:.3e}" for r in res.relative_residual], flush=True)
    print("cert bound :", [f"{r:.3e}" for r in res.certified_bound], flush=True)
    print(f"exp-sum sup: {res.expsum_sup:.3e}", flush=True)
    print(f"orthogonality drift max|<v_k,v_0>|: {res.orthogonality_drift:.3e}", flush=True)
    if res.boundary_drift_max is not None:
        print(f"boundary reorth drift max|<v,V>|: {res.boundary_drift_max:.3e}", flush=True)
    if res.projection_leak is not None:
        print(f"projection leak max|U^T u|/|u|: {res.projection_leak:.3e} (project_every={args.project_every})",
              flush=True)
    if res.relation_dev_term is not None:
        print(f"recorded relation: dev {res.relation_dev_term:.3e}, eta {res.relation_eta_term:.3e}, "
              f"r2 {res.relation_r2_term:.3e}, rho {res.perturbation_rho:.3e}, gram {res.gram_deviation:.3e}, "
              f"eft eps {res.eft_eps_measured:.3e}", flush=True)
    if res.pass2_gram_max is not None:
        print(f"pass-2 audit: sampled pairwise gram max {res.pass2_gram_max:.3e}, "
              f"replayed-beta rel dev {res.pass2_beta_rel_dev:.3e}", flush=True)
    final_bound = res.certified_bound[-1] if res.certified_bound else None
    cross_interp = interpret_cross_check(res.measured_cp_residual, res.cp_residual_floor, final_bound, args.tol)
    if res.measured_cp_residual is not None:
        print(f"measured CP residual cross-check: {res.measured_cp_residual:.3e} "
              f"(validity floor {res.cp_residual_floor:.3e}; {cross_interp})", flush=True)
    its = res.niterations / t_solve
    print(f"solve {t_solve:.1f}s ({its:.1f} it/s incl. checkpoints), total {wall:.1f}s", flush=True)

    out = args.out or os.path.join(_DATA, f"northstar_d{args.d}_n{args.n}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    artifact = {
        "problem": {
            "family": "reaction_diffusion (sigma*I - laplace_1d)",
            "d": args.d, "n": args.n, "sigma": sigma, "kappa": args.kappa, "seed": args.seed, "tol": args.tol,
            "lambda_min_exact": res.lambda_min, "lambda_max_gershgorin": res.lambda_max,
        },
        "recipe": {
            "solver": "solve_deflated", "m": res.m, "kmax": args.kmax, "orth": cfg.orth, "basis_dtype": "float64",
            "expsum_rank": res.expsum_rank, "eigh_impl_requested": args.eigh_impl,
            "eigh_impl_resolved": _resolve_eigh_impl(cfg, op),
            "storage_resolved": storage, "project_every": args.project_every, "sweep_every": args.sweep_every,
            "final": args.final, "state_save": not args.no_state_save, "checkpoints_requested": args.checkpoints,
        },
        "result": {
            "status": res.status, "converged": bool(res.converged), "niterations": res.niterations,
            "checkpoints": res.checkpoints, "relative_residual_estimate": res.relative_residual,
            "certified_bound": res.certified_bound, "expsum_sup": res.expsum_sup,
            "measured_cp_residual": res.measured_cp_residual, "cp_residual_floor": res.cp_residual_floor,
            "cp_residual_interpretation": cross_interp, "orthogonality_drift": res.orthogonality_drift,
            "pass2_gram_max": res.pass2_gram_max, "pass2_beta_rel_dev": res.pass2_beta_rel_dev,
            "projection_leak": res.projection_leak, "boundary_drift_max": res.boundary_drift_max,
            "relation_dev_term": res.relation_dev_term, "relation_eta_term": res.relation_eta_term,
            "relation_r2_term": res.relation_r2_term, "perturbation_rho": res.perturbation_rho,
            "gram_deviation": res.gram_deviation, "eft_eps_measured": res.eft_eps_measured,
        },
        "timing": {
            "device": kind, "device_count": torch.cuda.device_count() if device.type == "cuda" else 0,
            "setup_s": t_setup, "basis_loaded": loaded, "solve_s": t_solve, "total_s": wall,
            "iterations_per_s": its, "max_memory_allocated": peak,
        },
    }
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print("saved", out, flush=True)
    return artifact


if __name__ == "__main__":
    main()
