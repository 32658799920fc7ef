"""The κ = 1e6 flagship through solve_deflated on the card, one solve per
orth mode, with what its certificate assumes measured beside it.

Run on a machine with a CUDA device:

    python -m tensorkrylov_tpu_torch.experiments.flagship_probe [--orth lanczos_reorth_auto lanczos_reorth] [--m 2048]

For each orth mode: the solve (storage='full', the JAX package's flagship
recipe otherwise) with its status, bounds, basis-free cross-check and its
verdict, wall, peak memory, banded_spmv launches and the reorthogonalization
sweeps its steps ran; then the same recurrence driven alone to the solve's
last step, timed, and the orthonormality of its stored basis, max|V_kᵀV_k − I|
and max|U_sᵀV_k| (the certificate's bound holds when both are at roundoff);
the solve's other stages on that state, each synchronized and timed on the
host clock: the checkpoint evaluation (eigh of the padded T, the joint
(d, m+K, m+K) Lemma 3.4), the assembly x = U·Yu + V·Yv and the device
cross-check (its compensated Gram); and the two projection GEMMs of one step
timed with CUDA events beside their bound (U read twice at 3.35 TB/s). One
JSON line per orth mode, after the card's name and power limit.
"""
import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--orth", nargs="+", default=["lanczos_reorth_auto", "lanczos_reorth"])
    p.add_argument("--d", type=int, default=10)
    p.add_argument("--n", type=int, default=131072)
    p.add_argument("--kappa", type=float, default=1e6)
    p.add_argument("--m", type=int, default=2048)
    p.add_argument("--kmax", type=int, default=512)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--checkpoints", type=int, nargs="+", default=[384, 448, 512])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flagship_probe: no CUDA device")

    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch import deflate, deflate_light
    from tensorkrylov_tpu_torch.coeffs.tables import load_tables, select_bh
    from tensorkrylov_tpu_torch.utils.cp import cp_residual_cross_check_device
    from tensorkrylov_tpu_torch.experiments.northstar import interpret_cross_check, sigma_for_kappa
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.ops.orth import deflation_coeffs, deflation_project, deflation_subtract

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    sigma = sigma_for_kappa(args.n, args.kappa)
    op = tkt.reaction_diffusion(args.d, args.n, sigma, device=dev)
    b = tkt.random_rhs(args.d, args.n, seed=args.seed)
    b = (b / torch.linalg.vector_norm(b, dim=1, keepdim=True)).to(dev)
    t0 = time.perf_counter()
    basis = tkt.deflation_basis(op, args.m)
    setup_s = time.perf_counter() - t0

    sweeps = []
    real_sweep = deflate_light._sweep

    def counted_sweep(V, u, k):
        sweeps.append(k)
        return real_sweep(V, u, k)

    deflate_light._sweep = counted_sweep
    U = torch.tensor(basis.U, device=dev)
    for orth in args.orth:
        cfg = tkt.SolverConfig(kmax=args.kmax, tol=args.tol, orth=orth)
        sweeps.clear()
        _build.launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = tkt.solve_deflated(op, b, cfg, basis=basis, checkpoints=args.checkpoints, storage="full")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches, n_sweeps = dict(_build.launches), len(sweeps)
        k = res.niterations
        verdict = interpret_cross_check(res.measured_cp_residual, res.cp_residual_floor, res.certified_bound[-1],
                                        args.tol)
        res = dataclasses.replace(res, x=None)

        # the same recurrence alone: its loop's time and its basis's orthonormality
        reorth = {"lanczos": "never", "lanczos_reorth": "always", "lanczos_reorth_auto": "auto"}[orth]
        b_perp = deflation_subtract(b, U, deflation_coeffs(b, U))
        st = deflate_light._init_state(b_perp, k + 1)
        V = torch.zeros((k + 1, args.d, args.n), dtype=torch.float64, device=dev)
        V[0] = st.vp
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deflate_light._advance(op, st, b_perp, U, 1, k + 1, V=V, reorth=reorth)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        Vk = V[:k].transpose(0, 1)                                           # (d, k, n), strided
        G = torch.bmm(Vk, Vk.transpose(1, 2)) - torch.eye(k, dtype=V.dtype, device=dev)
        gram_dev = float(G.abs().max())
        u_leak = float((V[:k].reshape(k * args.d, args.n) @ U[0]).abs().max()) if U.shape[0] == 1 else None
        del Vk, G

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        lam = torch.tensor(np.ascontiguousarray(basis.lam), device=dev)
        lam_min = float(basis.lam[:, 0].sum())
        kappa = deflate._gershgorin_max(op) / lam_min
        co = select_bh(torch.tensor(kappa, dtype=torch.float64), 0.5 * args.tol / kappa, load_tables(), cfg.tmax)
        co = [t.to(dev) for t in (co.omega, co.alpha, co.t_mask)]
        c = deflation_coeffs(b, U)
        b_norm = float(torch.prod(torch.linalg.vector_norm(b, dim=1)))
        (rel, brs, Yu, Yv, w), eval_s = timed(lambda: deflate._evaluate(st.dg, st.od, st.btil, st.od[:, k], k, lam, c,
                                                                        b_norm, lam_min, *co))
        act = torch.nonzero(co[2] > 0)[:, 0]
        Yu, Yv, w = Yu[:, :, act], Yv[:, :, act], w[act]
        x, assemble_s = timed(lambda: deflate._assemble(U, V, Yu, Yv, k))
        del V
        _, cross_check_s = timed(lambda: cp_residual_cross_check_device(op, w, x, b))
        del x

        u = st.vp.clone()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            deflation_project(u, U)
        start.record()
        for _ in range(20):
            deflation_project(u, U)
        end.record()
        end.synchronize()
        proj_ms = start.elapsed_time(end) / 20
        print(json.dumps(dict(
            orth=orth, d=args.d, n=args.n, kappa=args.kappa, sigma=sigma, m=args.m, kmax=args.kmax, tol=args.tol,
            device=torch.cuda.get_device_name(0), nvidia_smi=smi, setup_s=setup_s, status=res.status,
            niterations=k, checkpoints=res.checkpoints, estimate=res.relative_residual,
            certified_bound=res.certified_bound, expsum_sup=res.expsum_sup, expsum_rank=res.expsum_rank,
            measured_cp_residual=res.measured_cp_residual, cp_residual_floor=res.cp_residual_floor,
            verdict=verdict, orthogonality_drift=res.orthogonality_drift, lambda_min=res.lambda_min,
            lambda_max=res.lambda_max, wall_s=wall, iterations_per_s=k / wall, max_memory_allocated=peak,
            launches=launches, sweeps=n_sweeps, krylov_loop_s=loop_s, krylov_ms_per_step=loop_s / k * 1e3,
            basis_gram_dev=gram_dev, basis_u_leak=u_leak, evaluate_s=eval_s, assemble_s=assemble_s,
            cross_check_s=cross_check_s, projection_ms=proj_ms,
            projection_bound_ms=2 * U.numel() * U.element_size() / HBM_BYTES_PER_S * 1e3)), flush=True)
    deflate_light._sweep = real_sweep


if __name__ == "__main__":
    main()
