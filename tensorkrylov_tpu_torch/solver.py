"""Tensorized Krylov solver: counterpart of ``tensorkrylov_tpu/solver.py``
for SPD Kronecker sums with a rank-1 right-hand side.

The JAX package runs the whole iteration in one jitted ``lax.while_loop``.
Here the loop is a host loop over eager tensor code on the operator's device:
each iteration runs one batched Krylov step, and every ``check_every`` steps
the projected stage (spectral estimate, exp-sum coefficients, CP solve,
Lemma-3.4 residual); the host reads the status after each check. The
projected stage stays on the device, in f64.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .coeffs.tables import TMAX, BHTables, ExpSumCoeffs, load_tables, select_bh, select_stenger
from .ops.eigen import analytic_laplace_extremes, dense_minor_window, masked_eigh, sym_extremes_from_eigs
from .ops.expsum import cp_solve_sym
from .ops.gram import residual_norm_sq
from .ops.orth import _acc_dtype, init_state, lanczos_step
from .types import CPTensor, KroneckerSumOperator, SolveResult, SolverConfig, Status

__all__ = ["solve", "projected_step", "SolverConfig"]

_REORTH = {"lanczos": False, "lanczos_reorth": True, "lanczos_reorth_auto": "auto"}


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


def projected_step(H, btil, subdiag, k, b_norm_prod, config: SolverConfig, tables: BHTables, n: int, W_A=None) -> ProjectedEval:
    """Spectral estimation → exp-sum coefficient selection → CP solve →
    Lemma-3.4 residual, for the symmetric (Lanczos) path; the nonsymmetric
    branch is not ported yet (ROADMAP.md Queue 1, slice 2, #10)."""
    d, K, _ = H.shape
    pdt = config.proj_dtype
    eig_d = 1 if config.identical_factors else d

    def eig(W):
        w, Q = masked_eigh(W[:eig_d], k)
        return (w.expand(d, K), Q.expand(d, K, K)) if config.identical_factors else (w, Q)

    w, Q = eig(W_A if config.spectral_source == "A_minor" else H)
    if config.spectral_source == "analytic_laplace":
        lmin, lmax = analytic_laplace_extremes(d, n, k, pdt, H.device)
    else:
        lmin, lmax = sym_extremes_from_eigs(w)
    # 'A_minor' estimates the spectrum from A's minors, but the solve still
    # diagonalizes H itself
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

    terms = residual_norm_sq(H, Y, btil, k, weights, subdiag)
    eps = torch.finfo(pdt).eps
    breakdown = terms.r_comp_sq < -config.breakdown_rel * eps * terms.cancel_scale
    # Below the cancellation floor the computed r_comp² is noise; substitute
    # the analytic exp-sum bound ‖Hy − b̃‖ ≤ ε·κ·‖b̃‖
    r_comp_bound = coeffs.err * kappa * b_norm_prod
    cancel_floor = config.cancel_floor_rel * eps * terms.cancel_scale
    r_comp_sq_eff = torch.where(
        terms.r_comp_sq > cancel_floor,
        terms.r_comp_sq,
        torch.minimum(torch.clamp(terms.r_comp_sq, min=0.0) + cancel_floor, r_comp_bound**2),
    )
    r_comp = torch.sqrt(torch.clamp(r_comp_sq_eff, min=0.0))
    r_norm = torch.sqrt(torch.clamp(terms.boundary_sq + r_comp_sq_eff, min=0.0))
    return ProjectedEval(weights, Y, r_norm / b_norm_prod, r_comp, lmin, lmax, coeffs.rank, breakdown)


def _resolve_config(config: SolverConfig, op: KroneckerSumOperator) -> SolverConfig:
    """Resolve the 'auto' settings for this operator and device; the resolved
    config is recorded on SolveResult.config."""
    if config.orth == "arnoldi":
        raise NotImplementedError(
            "orth='arnoldi' is not ported yet (ROADMAP.md Queue 1, slice 2, #9 and #10)")
    if config.eigh_impl == "host":
        raise ValueError("eigh_impl='host' is only supported by solve_deflated; use 'auto' or 'dense' for solve")
    if config.eigh_impl == "tridiag_mixed":
        raise NotImplementedError(
            "eigh_impl='tridiag_mixed' is not ported; native f64 torch.linalg.eigh ('dense') "
            "replaces it on the card (ROADMAP.md Queue 1, #20)")
    if config.eigh_impl == "auto":
        config = dataclasses.replace(config, eigh_impl="dense")
    if config.step_impl in ("auto", "resident"):
        # 'auto' stays the unfused step (whose SpMV is the CUDA kernel) until
        # a measurement on the card says the fused step wins; 'resident'
        # multi-step segments exist only in solve_host_projected
        config = dataclasses.replace(config, step_impl="xla")
    elif config.step_impl == "fused":
        ok = config.orth in ("lanczos", "lanczos_reorth_auto")
        config = dataclasses.replace(config, step_impl="fused" if ok else "xla")
    if config.kmax > op.n:
        # the factor Krylov spaces exhaust at dimension n
        config = dataclasses.replace(config, kmax=op.n)
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


def solve(op: KroneckerSumOperator, b, config: Optional[SolverConfig] = None, tables: Optional[BHTables] = None) -> SolveResult:
    """Solve the Kronecker-sum system A x = b, b = b_1⊗…⊗b_d given as (d, n),
    on the operator's device. Returns the CP solution and the telemetry."""
    config = config or SolverConfig()
    b = torch.as_tensor(b, device=op.device)
    if b.dim() != 2 or b.shape[0] != op.d or b.shape[1] != op.n:
        raise ValueError(f"b must be (d, n) = ({op.d}, {op.n}), got {tuple(b.shape)}")
    if not op.symmetric and config.orth != "arnoldi":
        raise ValueError("nonsymmetric operators require orth='arnoldi'")
    config = _resolve_config(config, op)
    _check_identical_factors(config, op, b)
    if tables is None:
        tables = load_tables(dtype=config.proj_dtype, device=op.device)

    d, n = b.shape
    K = config.kmax + 1
    pdt = config.proj_dtype
    dev = op.device
    op = op.astype(_acc_dtype(config.basis_dtype, pdt))
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
        state, loss = lanczos_step(
            op, state, b, k, reorth=_REORTH[config.orth], proj_dtype=pdt,
            fused=config.step_impl == "fused", reorth_tol=config.reorth_tol)
        orth[k] = loss
        if k % config.check_every == 0 or k >= config.kmax:
            ev = projected_step(state.H, state.btil, state.H[:, k, k - 1], k, b_norm_prod,
                                config, tables, n, W_A)
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

    # lift x_s = V_s[:, :k]^T Y_s; rows of Y at and beyond the last check are zero
    m = niter + 1
    x_factors = torch.bmm(state.V[:m].to(pdt).permute(1, 2, 0), Y[:, :m])
    return SolveResult(
        x=CPTensor(weights, x_factors),
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
