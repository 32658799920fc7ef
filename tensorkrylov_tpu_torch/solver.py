"""Tensorized Krylov solver: counterpart of ``tensorkrylov_tpu/solver.py``
for Kronecker sums with a rank-1 right-hand side, SPD (Lanczos) and
nonsymmetric (Arnoldi).

The JAX package runs the whole iteration in one jitted ``lax.while_loop``.
``solve`` here is a host loop over eager tensor code on the operator's device:
each iteration runs one batched Krylov step, and every ``check_every`` steps
the projected stage (spectral estimate, exp-sum coefficients, CP solve,
Lemma-3.4 residual); the host reads the status after each check. The
projected stage stays on the device, in f64.

``solve_host_projected`` runs the Krylov recurrences on the operator's device
in ``check_every``-step segments and the projected stage on the host CPU in
f64 between segments, as the JAX package's does. With
``step_impl='resident'`` each segment is one launch of the resident
multi-step Lanczos kernel (``ops/resident_lanczos.py``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .coeffs.tables import TMAX, BHTables, ExpSumCoeffs, load_tables, select_bh, select_stenger
from .ops.eigen import analytic_laplace_extremes, dense_minor_window, masked_eigh, sym_extremes_from_eigs
from .ops.expsum import cp_solve_nonsym, cp_solve_nonsym_eig, cp_solve_sym
from .ops.gram import residual_norm_sq
from .ops.orth import KrylovState, _acc_dtype, arnoldi_step, init_state, lanczos_step
from .ops.resident_lanczos import lanczos_resident_steps
from .types import CPTensor, KroneckerSumOperator, SolveResult, SolverConfig, Status

__all__ = ["solve", "solve_host_projected", "projected_step", "SolverConfig"]

_REORTH = {"lanczos": False, "lanczos_reorth": True, "lanczos_reorth_auto": "auto"}


def _step_fn(config: SolverConfig):
    """The Krylov step of config.orth: (op, state, b, k) → (state, loss)."""
    pdt = config.proj_dtype
    if config.orth == "arnoldi":
        return lambda op, st, b, k: arnoldi_step(op, st, b, k, proj_dtype=pdt)
    reorth, fused = _REORTH[config.orth], config.step_impl == "fused"
    return lambda op, st, b, k: lanczos_step(op, st, b, k, reorth=reorth, proj_dtype=pdt, fused=fused,
                                             reorth_tol=config.reorth_tol)


class ProjectedEval(NamedTuple):
    """Result of one projected-stage evaluation (a function of (H, b̃, k))."""

    weights: torch.Tensor   # (tmax,)
    Y: torch.Tensor         # (d, K, tmax)
    rel: torch.Tensor       # certified relative residual
    r_comp: torch.Tensor    # compressed residual (after floor/bound handling)
    lmin: torch.Tensor
    lmax: torch.Tensor
    rank: torch.Tensor      # int32 exp-sum term count
    breakdown: torch.Tensor  # bool


def _power_norm_sum(H, k):
    """Σ_s ‖H_s‖₂ of the active k×k blocks, by 8 power iterations on HᵀH
    (≥ λ_max of Σ⊕H_s, and much tighter than a Gershgorin row bound)."""
    d, K, _ = H.shape
    m = (torch.arange(K, device=H.device) < k).to(H.dtype)
    Hm = H * m[None, :, None] * m[None, None, :]
    v = (m / torch.sqrt(torch.clamp(torch.sum(m), min=1.0))).expand(d, K)
    for _ in range(8):
        u = torch.einsum("dij,dj->di", Hm, v)
        u = torch.einsum("dji,dj->di", Hm, u)
        v = u / torch.clamp(torch.linalg.vector_norm(u, dim=1, keepdim=True), min=1e-300)
    return torch.sum(torch.linalg.vector_norm(torch.einsum("dij,dj->di", Hm, v), dim=1))


def projected_step(H, btil, subdiag, k, b_norm_prod, config: SolverConfig, tables: Optional[BHTables],
                   symmetric: bool, n: int, W_A=None, lmin_override=None) -> ProjectedEval:
    """Spectral estimation → exp-sum coefficient selection → CP solve →
    Lemma-3.4 residual, on H's device.

    symmetric: the Lanczos path (eigh of the H_s minors, Braess–Hackbusch
    tables with the sinc rule as fallback) or the nonsymmetric path (Bendixson
    bound from the symmetric part, the sinc rule, and config.nonsym_solve_impl).
    lmin_override: an exact λ_min of the projected Kronecker sum (the host's
    nonsymmetric eigenvalues in solve_host_projected); it raises the
    Bendixson bound, which lowers the sinc rank.
    """
    d, K, _ = H.shape
    pdt = config.proj_dtype
    eig_d = 1 if config.identical_factors else d

    def eig(W):
        w, Q = masked_eigh(W[:eig_d], k)
        return (w.expand(d, K), Q.expand(d, K, K)) if config.identical_factors else (w, Q)

    if symmetric:
        w, Q = eig(W_A if config.spectral_source == "A_minor" else H)
        if config.spectral_source == "analytic_laplace":
            lmin, lmax = analytic_laplace_extremes(d, n, k, pdt, H.device)
        else:
            lmin, lmax = sym_extremes_from_eigs(w)
        # 'A_minor' estimates the spectrum from A's minors, but the solve
        # still diagonalizes H itself
        wh, Qh = eig(H) if config.spectral_source == "A_minor" else (w, Q)
        kappa = lmax / lmin
        coeff_tol = config.tol / kappa if config.coeff_tol_scale == "kappa" else config.tol
        coeffs = select_bh(kappa, coeff_tol, tables, config.tmax, config.bh_row_select)
        if config.tmax > TMAX:
            # when the optimal tables cannot reach the target, the longer
            # closed-form sinc rule may
            st = select_stenger(coeff_tol, config.tmax, pdt, H.device)
            use_st = (coeffs.err > coeff_tol) & (st.err < coeffs.err)
            coeffs = ExpSumCoeffs(*(torch.where(use_st, a, b) for a, b in zip(st, coeffs)))
        weights, Y = cp_solve_sym(wh, Qh, btil, k, coeffs.omega, coeffs.alpha, coeffs.t_mask, lmin)
        kappa_eff = kappa
    else:
        # Bendixson bound from the symmetric part of the H minors
        w, _ = eig(0.5 * (H + H.transpose(1, 2)))
        lmin, lmax = sym_extremes_from_eigs(w)
        if lmin_override is not None:
            lmin = torch.clamp(lmin, min=float(lmin_override))
        signorm = _power_norm_sum(H, k)
        # 'kappa' certifies the residual (ε·κ ≤ tol); 'reference' is tol·λ_min
        eps_target = config.tol * lmin / signorm if config.coeff_tol_scale == "kappa" else config.tol * lmin
        coeffs = select_stenger(eps_target, config.tmax, pdt, H.device)
        nonsym_solve = cp_solve_nonsym_eig if config.nonsym_solve_impl == "eig" else cp_solve_nonsym
        # identical factors and RHS rows make every (H_s, b̃_s) equal: solve once
        weights, Y = nonsym_solve(H[:eig_d], btil[:eig_d], k, coeffs.omega, coeffs.alpha, coeffs.t_mask, lmin)
        if eig_d != d:
            Y = Y.expand(d, *Y.shape[1:])
        kappa_eff = signorm / lmin

    terms = residual_norm_sq(H, Y, btil, k, weights, subdiag)
    eps = torch.finfo(pdt).eps
    breakdown = terms.r_comp_sq < -config.breakdown_rel * eps * terms.cancel_scale
    # Below the cancellation floor the computed r_comp² is noise; substitute
    # the analytic exp-sum bound ‖Hy − b̃‖ ≤ ε·κ·‖b̃‖
    r_comp_bound = coeffs.err * kappa_eff * b_norm_prod
    cancel_floor = config.cancel_floor_rel * eps * terms.cancel_scale
    r_comp_sq_eff = torch.where(
        terms.r_comp_sq > cancel_floor,
        terms.r_comp_sq,
        torch.minimum(torch.clamp(terms.r_comp_sq, min=0.0) + cancel_floor, r_comp_bound**2),
    )
    r_comp = torch.sqrt(torch.clamp(r_comp_sq_eff, min=0.0))
    r_norm = torch.sqrt(torch.clamp(terms.boundary_sq + r_comp_sq_eff, min=0.0))
    return ProjectedEval(weights, Y, r_norm / b_norm_prod, r_comp, lmin, lmax, coeffs.rank, breakdown)


def _resident_eligible(config: SolverConfig, op: KroneckerSumOperator) -> bool:
    """step_impl='resident' preconditions: plain Lanczos (the kernel has no
    reorthogonalization), a symmetric operator, an f32 basis. The JAX
    package's n % 128, halo and VMEM rules are the TPU kernel's and do not
    apply: the CUDA kernel masks its loads and takes any n and offsets."""
    return config.orth == "lanczos" and op.symmetric and config.basis_dtype == torch.float32


def _resolve_config(config: SolverConfig, op: KroneckerSumOperator, host_projected: bool = False) -> SolverConfig:
    """Resolve the 'auto' settings for this operator and entry point; the resolved
    config is recorded on SolveResult.config."""
    if config.eigh_impl == "host":
        raise ValueError("eigh_impl='host' is only supported by solve_deflated; use 'auto' or 'dense' for solve "
                         "(or solve_host_projected to run the whole projected stage on the host)")
    if config.eigh_impl == "tridiag_mixed":
        raise NotImplementedError(
            "eigh_impl='tridiag_mixed' is not ported; native f64 torch.linalg.eigh ('dense') "
            "replaces it on the card (ROADMAP.md Queue 1, #20)")
    if config.eigh_impl == "auto":
        config = dataclasses.replace(config, eigh_impl="dense")
    if config.step_impl == "auto":
        # the unfused step (whose SpMV is the CUDA kernel) until a measurement
        # on the card says the fused step wins
        config = dataclasses.replace(config, step_impl="xla")
    elif config.step_impl == "fused":
        ok = config.orth in ("lanczos", "lanczos_reorth_auto")
        config = dataclasses.replace(config, step_impl="fused" if ok else "xla")
    elif config.step_impl == "resident":
        # resident multi-step segments exist only in solve_host_projected;
        # an ineligible request takes the unfused step, recorded here
        ok = host_projected and _resident_eligible(config, op)
        config = dataclasses.replace(config, step_impl="resident" if ok else "xla")
    if config.kmax > op.n:
        # the factor Krylov spaces exhaust at dimension n
        config = dataclasses.replace(config, kmax=op.n)
    if config.nonsym_solve_impl == "auto":
        # torch.linalg.eig runs on the CPU and on CUDA alike; the JAX package
        # chose 'expm' on its device only because jnp.linalg.eig has no TPU
        # lowering
        config = dataclasses.replace(config, nonsym_solve_impl="eig")
    return config


def _check_identical_factors(config: SolverConfig, op: KroneckerSumOperator, b: torch.Tensor) -> None:
    """identical_factors=True diagonalizes only factor 0's projected matrix,
    which depends on A_s and b_s: check on host copies that all coincide."""
    if not config.identical_factors:
        return
    bh = b.detach().cpu()
    bands = op.bands.detach().cpu()
    rows_ok = bool(torch.all(bh == bh[..., :1, :]))
    bands_ok = bool(torch.all(bands == bands[:1]))
    if not (rows_ok and bands_ok):
        what = "factor matrices" if not bands_ok else "RHS factor vectors b_s"
        raise ValueError(
            f"identical_factors=True requires identical {what} across the d modes (the fast path "
            "broadcasts factor 0's projected eigendecomposition, which depends on BOTH A_s and b_s); "
            "use identical_factors=False for distinct factors/RHS rows")


def _check_problem(op: KroneckerSumOperator, b, config: SolverConfig) -> torch.Tensor:
    b = torch.as_tensor(b, device=op.device)
    if b.dim() != 2 or b.shape[0] != op.d or b.shape[1] != op.n:
        raise ValueError(f"b must be (d, n) = ({op.d}, {op.n}), got {tuple(b.shape)}")
    if not op.symmetric and config.orth != "arnoldi":
        raise ValueError("nonsymmetric operators require orth='arnoldi'")
    return b


def _lift(V, Y, niter):
    """x_s = V_s[:, :k]^T Y_s on V's device; rows of Y at and beyond the last
    check are zero."""
    m = niter + 1
    return torch.bmm(V[:m].to(Y.dtype).permute(1, 2, 0), Y[:, :m].to(V.device))


def solve(op: KroneckerSumOperator, b, config: Optional[SolverConfig] = None, tables: Optional[BHTables] = None) -> SolveResult:
    """Solve the Kronecker-sum system A x = b, b = b_1⊗…⊗b_d given as (d, n),
    on the operator's device. Returns the CP solution and the telemetry."""
    config = config or SolverConfig()
    b = _check_problem(op, b, config)
    config = _resolve_config(config, op)
    _check_identical_factors(config, op, b)
    if op.symmetric and tables is None:
        tables = load_tables(dtype=config.proj_dtype, device=op.device)

    d, n = b.shape
    K = config.kmax + 1
    pdt = config.proj_dtype
    dev = op.device
    symmetric = op.symmetric
    op = op.astype(_acc_dtype(config.basis_dtype, pdt))
    step = _step_fn(config)
    state, b_norms = init_state(op, b, config.kmax, pdt, config.basis_dtype)
    b_norm_prod = torch.prod(b_norms)
    W_A = dense_minor_window(op, K).to(pdt) if config.spectral_source == "A_minor" else None

    rel_res = torch.full((K,), float("inf"), dtype=pdt, device=dev)
    r_comp = torch.full((K,), float("inf"), dtype=pdt, device=dev)
    orth = torch.zeros((K,), dtype=pdt, device=dev)
    lmin_h = torch.zeros((K,), dtype=pdt, device=dev)
    lmax_h = torch.zeros((K,), dtype=pdt, device=dev)
    rank_h = torch.zeros((K,), dtype=torch.int32, device=dev)
    weights = torch.zeros((config.tmax,), dtype=pdt, device=dev)
    Y = torch.zeros((d, K, config.tmax), dtype=pdt, device=dev)

    status = Status.RUNNING
    k = 1
    while k <= config.kmax and status == Status.RUNNING:
        state, loss = step(op, state, b, k)
        orth[k] = loss
        if k % config.check_every == 0 or k >= config.kmax:
            ev = projected_step(state.H, state.btil, state.H[:, k, k - 1], k, b_norm_prod,
                                config, tables, symmetric, n, W_A)
            rel_res[k], r_comp[k], lmin_h[k], lmax_h[k], rank_h[k] = ev.rel, ev.r_comp, ev.lmin, ev.lmax, ev.rank
            code = torch.where(ev.breakdown, int(Status.BREAKDOWN),
                               torch.where(ev.rel < config.tol, int(Status.CONVERGED), int(Status.RUNNING)))
            status = Status(int(code))
            if config.debug:
                print(f"k={k}  rel_res={float(ev.rel):.3e}  r_comp={float(ev.r_comp):.3e}  "
                      f"λ∈[{float(ev.lmin):.3e},{float(ev.lmax):.3e}]  t={int(ev.rank)}")
            # on breakdown the projected solution is untrustworthy: keep the previous one
            if status != Status.BREAKDOWN:
                weights, Y = ev.weights, ev.Y
        k += 1
    niter = k - 1
    if status == Status.RUNNING:
        status = Status.MAXITER

    return SolveResult(
        x=CPTensor(weights, _lift(state.V, Y, niter)),
        status=int(status),
        niterations=niter,
        relative_residual=rel_res,
        projected_residual=r_comp,
        orthogonality=orth,
        lambda_min=lmin_h,
        lambda_max=lmax_h,
        expsum_rank=rank_h,
        config=config,
    )


def _resident_segment_update(op32: KroneckerSumOperator, state: KrylovState, b: torch.Tensor, k0: int, S: int) -> KrylovState:
    """Steps k0..k0+S-1 in one call of the resident multi-step kernel (plain
    f32 Lanczos: no reorthogonalization, no lucky restart; an estimate-grade
    mode whose f32 basis floors the true residual, like the plain f32 step).
    op32 has f32 bands and state an f32 basis.

    Updates the state in place: the kernel writes the new columns straight
    into the slab V[k0:k0+S] of the K-leading basis, and the α/β entries of H
    and b̃_j = ⟨v_j, b⟩ (b rounded to f32, the f32 products summed in the
    projected dtype) are set for the segment."""
    V, H, btil, beta = state
    pdt = H.dtype
    vp = V[k0 - 1]
    vpp = V[k0 - 2] if k0 >= 2 else torch.zeros_like(vp)
    out = lanczos_resident_steps(op32, vp, vpp, beta.to(torch.float32), S, out=V[k0:k0 + S])
    idx = torch.arange(k0 - 1, k0 - 1 + S, device=H.device)
    H[:, idx, idx] = out.alpha.to(pdt)
    H[:, idx + 1, idx] = out.beta.to(pdt)
    H[:, idx, idx + 1] = out.beta.to(pdt)
    btil[:, idx + 1] = torch.einsum("sdn,dn->ds", out.V.to(pdt), b.to(torch.float32).to(pdt))
    return KrylovState(V, H, btil, out.beta_last.to(beta.dtype))


def _steps_segment(op: KroneckerSumOperator, b, step, state: KrylovState, k_start: int, k_end: int) -> KrylovState:
    """Krylov steps k_start..k_end only (no projected stage)."""
    for k in range(k_start, k_end + 1):
        state, _ = step(op, state, b, k)
    return state


def solve_host_projected(op: KroneckerSumOperator, b, config: Optional[SolverConfig] = None,
                         tables: Optional[BHTables] = None) -> SolveResult:
    """Hybrid execution: the operator's device runs the n-sized Krylov
    recurrences in check_every-step segments; between segments H and b̃ move
    to the host once, and the k-sized projected stage (eigh, coefficient
    selection, exp-sum CP solve, Lemma-3.4 residual) runs there in f64, by the
    same projected_step. For a nonsymmetric operator the host also takes the
    exact λ_min(Σ⊕H_s) = Σ_s min Re λ(H_s[:k, :k]) from numpy's eigvals,
    which is tighter than the Bendixson bound and lowers the sinc rank.

    step_impl='resident' (plain Lanczos, symmetric operator, f32 basis) runs
    each segment as one launch of the resident multi-step Lanczos kernel; an
    ineligible request takes the unfused step, as SolveResult.config records.

    The solution is lifted on the operator's device; the telemetry tensors
    were made on the host and stay there.
    """
    config = config or SolverConfig()
    b = _check_problem(op, b, config)
    config = _resolve_config(config, op, host_projected=True)
    _check_identical_factors(config, op, b)
    cpu = torch.device("cpu")
    pdt = config.proj_dtype
    if op.symmetric:
        tables = BHTables(*(t.to(cpu) for t in tables)) if tables is not None else load_tables(dtype=pdt)

    d, n = b.shape
    K = config.kmax + 1
    op_c = op.astype(_acc_dtype(config.basis_dtype, pdt))
    state, b_norms = init_state(op_c, b, config.kmax, pdt, config.basis_dtype)
    b_norm_prod = torch.tensor(float(np.prod(b_norms.cpu().numpy())), dtype=pdt)
    W_A = None
    if config.spectral_source == "A_minor":
        op_cpu = KroneckerSumOperator(op.bands.cpu(), op.offsets, op.symmetric)
        W_A = dense_minor_window(op_cpu, K).to(pdt)
    hist = {name: np.full((K,), np.inf if name in ("rel_res", "r_comp") else 0.0)
            for name in ("rel_res", "r_comp", "orth", "lmin", "lmax")}
    rank_h = np.zeros((K,), np.int32)

    step = _step_fn(config)
    status = Status.RUNNING
    k, niter = 1, 0
    weights = torch.zeros((config.tmax,), dtype=pdt)
    Y = torch.zeros((d, K, config.tmax), dtype=pdt)
    while k <= config.kmax and status == Status.RUNNING:
        k_end = min(k + config.check_every - 1, config.kmax)
        if config.step_impl == "resident":  # op_c and the basis are f32 then
            state = _resident_segment_update(op_c, state, b, k, k_end - k + 1)
        else:
            state = _steps_segment(op_c, b, step, state, k, k_end)
        H, btil = state.H.to(cpu), state.btil.to(cpu)
        # v_0-drift probes of the segment: |⟨v_j, v_0⟩| = |b̃_j|/‖b_s‖
        bt = btil.numpy()
        hist["orth"][k:k_end + 1] = np.max(np.abs(bt[:, k:k_end + 1]) / (np.abs(bt[:, :1]) + 1e-300), axis=0)
        lmin_exact = None
        if not op.symmetric:
            eig_d = 1 if config.identical_factors else d
            Hn = H.numpy()
            mins = [np.min(np.linalg.eigvals(Hn[s, :k_end, :k_end]).real) for s in range(eig_d)]
            lmin_exact = float(np.sum(mins)) * (d // eig_d)
        ev = projected_step(H, btil, H[:, k_end, k_end - 1], k_end, b_norm_prod, config, tables, op.symmetric, n,
                            W_A, lmin_exact)
        rel = float(ev.rel)
        hist["rel_res"][k_end], hist["r_comp"][k_end] = rel, float(ev.r_comp)
        hist["lmin"][k_end], hist["lmax"][k_end] = float(ev.lmin), float(ev.lmax)
        rank_h[k_end] = int(ev.rank)
        niter = k_end
        if bool(ev.breakdown):
            # the projected solution is untrustworthy: keep the previous one
            status = Status.BREAKDOWN
        else:
            if rel < config.tol:
                status = Status.CONVERGED
            weights, Y = ev.weights, ev.Y
        k = k_end + 1
    if status == Status.RUNNING:
        status = Status.MAXITER

    return SolveResult(
        x=CPTensor(weights.to(op.device), _lift(state.V, Y, niter)),
        status=int(status),
        niterations=niter,
        relative_residual=torch.from_numpy(hist["rel_res"]),
        projected_residual=torch.from_numpy(hist["r_comp"]),
        orthogonality=torch.from_numpy(hist["orth"]),
        lambda_min=torch.from_numpy(hist["lmin"]),
        lambda_max=torch.from_numpy(hist["lmax"]),
        expsum_rank=torch.from_numpy(rank_h),
        config=config,
    )
