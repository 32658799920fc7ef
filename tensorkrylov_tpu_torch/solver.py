"""Tensorized Krylov solver: counterpart of ``tensorkrylov_tpu/solver.py``
for Kronecker sums with a rank-1 right-hand side, SPD (Lanczos) and
nonsymmetric (Arnoldi).

The JAX package runs the whole iteration in one jitted ``lax.while_loop``.
``solve`` here is a host loop over eager tensor code on the operator's device:
each iteration runs one batched Krylov step, and every ``check_every`` steps
the projected stage (spectral estimate, exp-sum coefficients, CP solve,
Lemma-3.4 residual); the host reads the status after each check. The
projected stage stays on the device, in f64. The loop is split into setup,
segment and finalize, as the JAX package's is: ``solve`` is one segment to
kmax, ``solve_resumable`` the same segment in chunks with a checkpoint
between them. ``solve_multi_rhs`` solves a rank-R right-hand side as R
rank-1 solves.

``solve_host_projected`` runs the Krylov recurrences on the operator's device
in ``check_every``-step segments and the projected stage on the host CPU in
f64 between segments, as the JAX package's does. With
``step_impl='resident'`` each segment is one launch of the resident
multi-step Lanczos kernel (``ops/resident_lanczos.py``).

Every entry point takes a ``ShardedOperator`` (``parallel/sharding.py``) in
place of the operator, b whole or its pieces: the same loop runs the step
over the shard pieces and the projected stage on the lead device, where x is
gathered. The fused and resident kernels run one whole piece, so a sharded
solve takes the unfused step.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .coeffs.tables import TMAX, BHTables, ExpSumCoeffs, load_tables, select_bh, select_stenger
from .ops.eigen import (analytic_laplace_extremes, dense_minor_window, masked_eigh, masked_eigh_tridiag_mixed,
                        sym_extremes_from_eigs)
from .ops.expsum import cp_solve_nonsym, cp_solve_nonsym_eig, cp_solve_sym
from .ops.gram import residual_norm_sq
from .ops.orth import _REORTH, KrylovState, _acc_dtype, arnoldi_step, init_state, lanczos_step
from .ops.resident_lanczos import lanczos_resident_steps
from .parallel.krylov import like, pieces, scatter, whole
from .parallel.sharding import Mesh, ShardedOperator, rhs_pieces, shard_operator
from .types import CPTensor, KroneckerSumOperator, SolveResult, SolverConfig, Status
from .utils.checkpoint import load_carry, save_carry
from .utils.profiling import host_read, span

__all__ = ["solve", "solve_host_projected", "solve_resumable", "solve_multi_rhs", "solve_on_mesh", "MultiRhsResult",
           "projected_step", "SolverConfig"]

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
    # H is tridiagonal on the Lanczos path: the tridiagonal eigensolver where
    # asked, its vectors refined twice only for an f64 basis
    eigh_H = masked_eigh
    if config.eigh_impl == "tridiag_mixed" and config.orth != "arnoldi":
        eigh_H = functools.partial(masked_eigh_tridiag_mixed, refine_vectors=config.basis_dtype == torch.float64)

    def eig(W, eigh=masked_eigh):
        w, Q = eigh(W[:eig_d], k)
        return (w.expand(d, K), Q.expand(d, K, K)) if config.identical_factors else (w, Q)

    if symmetric:
        # 'A_minor' estimates the spectrum from A's dense minors, but the solve
        # still diagonalizes H itself
        w, Q = eig(W_A) if config.spectral_source == "A_minor" else eig(H, eigh_H)
        if config.spectral_source == "analytic_laplace":
            lmin, lmax = analytic_laplace_extremes(d, n, k, pdt, H.device)
        else:
            lmin, lmax = sym_extremes_from_eigs(w)
        wh, Qh = eig(H, eigh_H) if config.spectral_source == "A_minor" else (w, Q)
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
        with span("solve.check.bendixson"):
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
        with span("solve.check.eig"):
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


def auto_eigh_impl(device_type: str, symmetric: bool, orth: str, host_projected: bool = False) -> str:
    """What eigh_impl='auto' resolves to (JAX solver.py:440-447, "on the TPU"
    read as "on a CUDA device"): the tridiagonal eigensolver for a symmetric
    Lanczos solve whose projected stage runs on the card, the dense eigh
    everywhere else, every CPU run included."""
    tridiag = device_type == "cuda" and symmetric and orth != "arnoldi" and not host_projected
    return "tridiag_mixed" if tridiag else "dense"


def _resolve_config(config: SolverConfig, op, host_projected: bool = False) -> SolverConfig:
    """Resolve the 'auto' settings for this operator and entry point; the resolved
    config is recorded on SolveResult.config. A ShardedOperator takes the
    unfused step: 'auto' is 'xla' for it as for one piece, and an explicit
    'fused' (or 'resident' in solve_host_projected) raises, since those
    kernels run on one whole piece."""
    if isinstance(op, ShardedOperator):
        if config.step_impl == "fused":
            raise ValueError("step_impl='fused' runs on one piece: the fused core sums α, β² and ⟨u, b⟩ over the "
                             "whole n and has no psum over shards (ops/orth.py); a ShardedOperator takes "
                             "step_impl='auto' or 'xla'")
        if config.step_impl == "resident" and host_projected:
            raise ValueError("step_impl='resident' runs on one piece: the resident kernel keeps a whole factor's "
                             "recurrence on one card (ops/resident_lanczos.py); a ShardedOperator takes "
                             "step_impl='auto' or 'xla'")
    if config.eigh_impl == "host":
        raise ValueError("eigh_impl='host' is only supported by solve_deflated; use 'auto', 'dense' or "
                         "'tridiag_mixed' for solve "
                         "(or solve_host_projected to run the whole projected stage on the host)")
    if config.eigh_impl == "auto":
        impl = auto_eigh_impl(op.device.type, op.symmetric, config.orth, host_projected)
        config = dataclasses.replace(config, eigh_impl=impl)
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


def _check_identical_factors(config: SolverConfig, op, b) -> None:
    """identical_factors=True diagonalizes only factor 0's projected matrix,
    which depends on A_s and b_s: check on host copies that all coincide
    (b (…, d, n), or its pieces over a ShardedOperator)."""
    if not config.identical_factors:
        return
    if isinstance(op, ShardedOperator):
        bands = op.leading_bands(op.n).cpu()
        b = whole(op, b, factor_axis=pieces(b)[0].dim() - 2)
    else:
        bands = op.bands.detach().cpu()
    bh = b.detach().cpu()
    rows_ok = bool(torch.all(bh == bh[..., :1, :]))
    bands_ok = bool(torch.all(bands == bands[:1]))
    if not (rows_ok and bands_ok):
        what = "factor matrices" if not bands_ok else "RHS factor vectors b_s"
        raise ValueError(
            f"identical_factors=True requires identical {what} across the d modes (the fast path "
            "broadcasts factor 0's projected eigendecomposition, which depends on BOTH A_s and b_s); "
            "use identical_factors=False for distinct factors/RHS rows")


def _check_problem(op, b, config: SolverConfig):
    """b (d, n) on the operator's device; over a ShardedOperator, b whole
    (then split) or its pieces, as parallel/sharding.rhs_pieces takes them."""
    if isinstance(op, ShardedOperator):
        b = rhs_pieces(op, b)
    else:
        b = torch.as_tensor(b, device=op.device)
        if b.dim() != 2 or b.shape[0] != op.d or b.shape[1] != op.n:
            raise ValueError(f"b must be (d, n) = ({op.d}, {op.n}), got {tuple(b.shape)}")
    if not op.symmetric and config.orth != "arnoldi":
        raise ValueError("nonsymmetric operators require orth='arnoldi'")
    return b


def _check_block(op, B):
    """A block right-hand side B (R, d, n) on the operator's device; over a
    ShardedOperator, B whole (then split) or its (R, d_f, n_local) pieces."""
    if isinstance(op, ShardedOperator):
        return rhs_pieces(op, B, block=True)
    B = torch.as_tensor(B, device=op.device)
    if B.dim() != 3 or B.shape[1] != op.d or B.shape[2] != op.n:
        raise ValueError(f"B must be (R, d, n) = (R, {op.d}, {op.n}), got {tuple(B.shape)}")
    return B


def _minor_window(op, K: int) -> torch.Tensor:
    """dense_minor_window of op's leading K columns, on op's device; over a
    ShardedOperator from the shards that hold those columns."""
    if isinstance(op, ShardedOperator):
        op = KroneckerSumOperator(op.leading_bands(min(K, op.n)), op.offsets, op.symmetric)
    return dense_minor_window(op, K)


def _lift(V, Y, niter):
    """x_s = V_s[:, :k]^T Y_s on V's device; rows of Y at and beyond the last
    check are zero."""
    m = niter + 1
    return torch.bmm(V[:m].to(Y.dtype).permute(1, 2, 0), Y[:, :m].to(V.device))


def _lift_pieces(op, V, Y, niter):
    """_lift on every piece of V, each with its factors' rows of Y, the
    pieces gathered (d, n, t) on the lead device; one piece is _lift."""
    return whole(op, like(V, [_lift(Vi, Yi, niter) for Vi, Yi in zip(pieces(V), scatter(op, Y))]), axis=1)


class _Problem(NamedTuple):
    """What a solve's segments share and never change."""

    op: KroneckerSumOperator    # bands in the Krylov step's compute dtype (or a ShardedOperator)
    b: torch.Tensor              # (or its pieces)
    config: SolverConfig         # resolved
    tables: Optional[BHTables]
    step: object                 # _step_fn(config)
    b_norm_prod: torch.Tensor
    W_A: Optional[torch.Tensor]
    symmetric: bool


class _History(NamedTuple):
    """A solve's per-step telemetry, kmax + 1 entries each, written in place
    at the checks (orth at every step)."""

    rel_res: torch.Tensor
    r_comp: torch.Tensor
    orth: torch.Tensor
    lmin_h: torch.Tensor
    lmax_h: torch.Tensor
    rank_h: torch.Tensor


def _new_history(K: int, pdt, dev) -> _History:
    inf = float("inf")
    return _History(*(torch.full((K,), v, dtype=pdt, device=dev) for v in (inf, inf, 0.0, 0.0, 0.0)),
                    rank_h=torch.zeros((K,), dtype=torch.int32, device=dev))


def _record_check(h, k: int, ev: ProjectedEval, config: SolverConfig) -> Status:
    """Write check k's estimate into the histories of h (a _History or a
    _Carry) and return the status it decides: BREAKDOWN, CONVERGED or
    RUNNING. On BREAKDOWN the caller keeps its previous projected solution."""
    h.rel_res[k], h.r_comp[k], h.lmin_h[k], h.lmax_h[k], h.rank_h[k] = ev.rel, ev.r_comp, ev.lmin, ev.lmax, ev.rank
    code = torch.where(ev.breakdown, int(Status.BREAKDOWN),
                       torch.where(ev.rel < config.tol, int(Status.CONVERGED), int(Status.RUNNING)))
    if config.debug:
        print(f"k={k}  rel_res={float(ev.rel):.3e}  r_comp={float(ev.r_comp):.3e}  "
              f"λ∈[{float(ev.lmin):.3e},{float(ev.lmax):.3e}]  t={int(ev.rank)}")
    return Status(host_read(code, int))


def _result(x: CPTensor, status, niter: int, h, config: SolverConfig) -> SolveResult:
    """The SolveResult of a finished loop; a status still RUNNING is MAXITER."""
    return SolveResult(
        x=x,
        status=int(Status.MAXITER if status == Status.RUNNING else Status(status)),
        niterations=niter,
        relative_residual=h.rel_res,
        projected_residual=h.r_comp,
        orthogonality=h.orth,
        lambda_min=h.lmin_h,
        lambda_max=h.lmax_h,
        expsum_rank=h.rank_h,
        config=config,
    )


class _Carry(NamedTuple):
    """A solve's state between segments: the Krylov state, the next step k,
    the status, the last projected solution and the histories. Everything a
    resumed solve needs, so save_carry/load_carry round-trips it exactly."""

    V: torch.Tensor
    H: torch.Tensor
    btil: torch.Tensor
    beta: torch.Tensor
    k: int
    status: int
    weights: torch.Tensor
    Y: torch.Tensor
    rel_res: torch.Tensor
    r_comp: torch.Tensor
    orth: torch.Tensor
    lmin_h: torch.Tensor
    lmax_h: torch.Tensor
    rank_h: torch.Tensor


def _setup(op, b, config: Optional[SolverConfig], tables: Optional[BHTables]):
    """Check the problem, resolve the config, and make the initial carry. op
    is a KroneckerSumOperator, or a ShardedOperator with b whole or its
    pieces: the carry's V is then the per-shard slabs, the rest lives on the
    lead device."""
    config = config or SolverConfig()
    b = _check_problem(op, b, config)
    config = _resolve_config(config, op)
    _check_identical_factors(config, op, b)
    if op.symmetric and tables is None:
        with span("solve.tables"):
            tables = load_tables(dtype=config.proj_dtype, device=op.device)

    K = config.kmax + 1
    pdt = config.proj_dtype
    op_c = op.astype(_acc_dtype(config.basis_dtype, pdt))
    state, b_norms = init_state(op_c, b, config.kmax, pdt, config.basis_dtype)
    W_A = _minor_window(op_c, K).to(pdt) if config.spectral_source == "A_minor" else None
    problem = _Problem(op_c, b, config, tables, _step_fn(config), torch.prod(b_norms), W_A, op.symmetric)
    return problem, _initial_carry(state, config, op.d, op.device)


def _initial_carry(state: KrylovState, config: SolverConfig, d: int, dev) -> _Carry:
    """The carry before step 1: the initial Krylov state and empty histories on dev."""
    K, pdt = config.kmax + 1, config.proj_dtype
    return _Carry(
        *state, k=1, status=int(Status.RUNNING),
        weights=torch.zeros((config.tmax,), dtype=pdt, device=dev),
        Y=torch.zeros((d, K, config.tmax), dtype=pdt, device=dev),
        **_new_history(K, pdt, dev)._asdict(),
    )


def _segment(p: _Problem, c: _Carry, k_end: int) -> _Carry:
    """Steps c.k..min(k_end, kmax), each followed by the projected stage when
    the check cadence falls on it, until the status leaves RUNNING. The
    histories are written in place."""
    config = p.config
    state = KrylovState(c.V, c.H, c.btil, c.beta)
    k, status, weights, Y = c.k, Status(c.status), c.weights, c.Y
    while k <= min(k_end, config.kmax) and status == Status.RUNNING:
        with span("solve.step"):
            state, loss = p.step(p.op, state, p.b, k)
        c.orth[k] = loss
        if k % config.check_every == 0 or k >= config.kmax:
            with span("solve.check"):
                ev = projected_step(state.H, state.btil, state.H[:, k, k - 1], k, p.b_norm_prod,
                                    config, p.tables, p.symmetric, p.op.n, p.W_A)
                status = _record_check(c, k, ev, config)
            # on breakdown the projected solution is untrustworthy: keep the previous one
            if status != Status.BREAKDOWN:
                weights, Y = ev.weights, ev.Y
        k += 1
    return c._replace(V=state.V, H=state.H, btil=state.btil, beta=state.beta, k=k, status=int(status),
                      weights=weights, Y=Y)


def _finalize(p: _Problem, c: _Carry) -> SolveResult:
    niter = c.k - 1
    with span("solve.finalize"):
        return _result(CPTensor(c.weights, _lift_pieces(p.op, c.V, c.Y, niter)), c.status, niter, c, p.config)


def solve(op, b, config: Optional[SolverConfig] = None, tables: Optional[BHTables] = None) -> SolveResult:
    """Solve the Kronecker-sum system A x = b, b = b_1⊗…⊗b_d given as (d, n),
    on the operator's device. Returns the CP solution and the telemetry.

    op may be a ShardedOperator (parallel/sharding.shard_operator), the JAX
    package's solve_sharded call: b whole (it is split) or its pieces
    (shard_rhs), the Krylov bases split over the mesh, the step over the
    pieces, the projected stage on the lead device and x gathered there.

    One segment from step 1 to kmax: solve_resumable runs the same segment
    in chunks and gives the same bits.

    Spans (utils/profiling.py): 'solve' over the call, 'solve.tables',
    'solve.step' for each Krylov step, 'solve.check' for each projected
    stage with the status read that ends it, 'solve.finalize'. On the
    nonsymmetric path each check has two children: 'solve.check.bendixson'
    (the symmetric part's eigh and the norm sum) and 'solve.check.eig' (the
    CP solve, config.nonsym_solve_impl's)."""
    with span("solve", device=op.device):
        p, carry = _setup(op, b, config, tables)
        return _finalize(p, _segment(p, carry, p.config.kmax))


def solve_on_mesh(op: KroneckerSumOperator, b, config: SolverConfig, mesh: Mesh, comm: str,
                  tables: Optional[BHTables] = None) -> SolveResult:
    """solve() with the operator, b and the Krylov bases split over mesh
    (parallel/sharding.py:solve_sharded checks comm and forces the step):
    the operator in the step's compute dtype is sharded here, and solve()
    runs the sharded problem."""
    b = _check_problem(op, b, config)   # before any work
    sop = shard_operator(op.astype(_acc_dtype(config.basis_dtype, config.proj_dtype)), mesh, comm)
    return solve(sop, b, config, tables)


def solve_resumable(op: KroneckerSumOperator, b, config: Optional[SolverConfig] = None,
                    tables: Optional[BHTables] = None, chunk: int = 32, checkpoint_path: Optional[str] = None,
                    resume: bool = False) -> SolveResult:
    """solve() in chunk-step segments, with the whole carry (basis, projected
    matrices, histories, status, k) written to checkpoint_path after each
    segment when it is given. resume=True starts from the carry at
    checkpoint_path. Segments and a restore are exact, so the result equals
    solve()'s bit for bit. Its spans are solve()'s, under one 'solve' root."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if checkpoint_path and isinstance(op, ShardedOperator) and op.mesh.processes > 1:
        raise NotImplementedError("solve_resumable(checkpoint_path=) over a mesh across processes is not ported: "
                                  "each rank holds only its basis pieces, and every rank would write the one "
                                  "checkpoint; chunk without a checkpoint, or use a one-process mesh "
                                  "(ROADMAP.md Queue 1, #13)")
    with span("solve", device=op.device):
        p, carry = _setup(op, b, config, tables)
        if resume and checkpoint_path:
            carry = load_carry(checkpoint_path, carry)
        while carry.k <= p.config.kmax and carry.status == Status.RUNNING:
            carry = _segment(p, carry, carry.k + chunk - 1)
            if checkpoint_path:
                save_carry(checkpoint_path, carry)
        return _finalize(p, carry)


class MultiRhsResult(NamedTuple):
    """(x, results): the combined CP solution and the per-term results, whose
    telemetry tensors (and status, niterations, x) have a leading (R,).
    status and converged aggregate the R statuses: CONVERGED when all
    converged, else BREAKDOWN when any broke down, else MAXITER."""

    x: CPTensor
    results: SolveResult

    @property
    def status(self) -> int:
        st = self.results.status
        if bool(torch.all(st == Status.CONVERGED)):
            return int(Status.CONVERGED)
        return int(Status.BREAKDOWN if bool(torch.any(st == Status.BREAKDOWN)) else Status.MAXITER)

    @property
    def converged(self) -> bool:
        return self.status == Status.CONVERGED


def _lane_groups(op, B, config: SolverConfig, mesh: Optional[Mesh], comm: str):
    """solve_multi_rhs's lanes: [(the operator a group solves on, its lanes'
    right-hand sides)]. Over a ShardedOperator or a 2-D mesh one group runs
    every lane over that mesh; over a ('rhs', 'factor', 'mode') mesh rhs
    group g runs lanes [g·R/G, (g+1)·R/G) over its own grid."""
    if isinstance(op, ShardedOperator) and mesh is not None:
        raise ValueError("solve_multi_rhs takes a ShardedOperator or mesh=, not both: the operator is already split "
                         "over its mesh")
    B = _check_block(op, B)
    if isinstance(op, ShardedOperator):
        return [(op, [[x[r] for x in B] for r in range(B[0].shape[0])])]
    if mesh is None:
        return [(op, list(B))]
    grids = mesh.rhs_groups()
    G, R = len(grids), B.shape[0]
    if R % G:
        raise ValueError(f"B's {R} right-hand sides do not split over the mesh's {G} rhs groups")
    op_c = op.astype(_acc_dtype(config.basis_dtype, config.proj_dtype))
    L = R // G
    return [(shard_operator(op_c, grid, comm), list(B[g * L:(g + 1) * L])) for g, grid in enumerate(grids)]


def solve_multi_rhs(op, B, config: Optional[SolverConfig] = None, tables: Optional[BHTables] = None,
                    mesh: Optional[Mesh] = None, comm: str = "gspmd") -> MultiRhsResult:
    """Solve A x = b for a rank-R tensor-product RHS b = Σ_r ⊗_s B[r, s],
    B (R, d, n). By linearity x is the sum of the R rank-1 solutions.

    The JAX package vmaps its whole while-loop over r, and a finished lane
    freezes, so each lane equals a rank-1 solve; here the R rank-1 solves run
    in turn and their results are stacked in r order. The step is the
    unfused one ('xla'), as in the JAX package. x has rank Σ_r t_r: the
    terms' weights and factor columns concatenated.

    Over a mesh the lanes are solved split: op a ShardedOperator (B whole or
    its (R, d_f, n_local) pieces) or mesh= a 2-D mesh runs the R solves in
    turn over that mesh; mesh= a ('rhs', 'factor', 'mode') mesh
    (make_mesh(rhs_parallel=G)) gives each of its G rhs groups R/G lanes
    (R % G == 0), each solved over the group's own grid with comm's SpMV.
    One controller runs the groups in turn; x and the telemetry are gathered
    to the mesh's lead device."""
    config = _resolve_config(dataclasses.replace(config or SolverConfig(), step_impl="xla"), op)
    groups = _lane_groups(op, B, config, mesh, comm)
    lead = op.device if mesh is None else mesh.lead
    if op.symmetric and tables is None:
        tables = load_tables(dtype=config.proj_dtype, device=lead)

    runs = [solve(sop, b, config, tables) for sop, lanes in groups for b in lanes]
    stacked = {f: torch.stack([getattr(r, f).to(lead) for r in runs])
               for f in ("relative_residual", "projected_residual", "orthogonality", "lambda_min", "lambda_max",
                         "expsum_rank")}
    R = len(runs)
    res = SolveResult(
        x=CPTensor(torch.stack([r.x.weights.to(lead) for r in runs]),
                   torch.stack([r.x.factors.to(lead) for r in runs])),
        status=torch.tensor([r.status for r in runs], dtype=torch.int32),
        niterations=torch.tensor([r.niterations for r in runs], dtype=torch.int32),
        config=runs[0].config,
        **stacked,
    )
    tmax = config.tmax
    # combine: concatenate the CP terms of the rank-1 solves
    weights = res.x.weights.reshape(R * tmax)
    factors = torch.movedim(res.x.factors, 0, 2).reshape(op.d, op.n, R * tmax)
    return MultiRhsResult(CPTensor(weights, factors), res)


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


def solve_host_projected(op, b, config: Optional[SolverConfig] = None,
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

    op may be a ShardedOperator: the segments run the unfused step over the
    shard pieces ('auto' is 'xla'; 'resident', whose kernel runs one whole
    piece, raises), the lift runs per shard and x is gathered to the lead.
    """
    config = config or SolverConfig()
    b = _check_problem(op, b, config)
    config = _resolve_config(config, op, host_projected=True)
    _check_identical_factors(config, op, b)
    cpu = torch.device("cpu")
    pdt = config.proj_dtype
    if op.symmetric:
        tables = BHTables(*(t.to(cpu) for t in tables)) if tables is not None else load_tables(dtype=pdt)

    d, n = op.d, op.n
    K = config.kmax + 1
    op_c = op.astype(_acc_dtype(config.basis_dtype, pdt))
    state, b_norms = init_state(op_c, b, config.kmax, pdt, config.basis_dtype)
    b_norm_prod = torch.tensor(float(np.prod(b_norms.cpu().numpy())), dtype=pdt)
    W_A = _minor_window(op, K).to(cpu).to(pdt) if config.spectral_source == "A_minor" else None
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
        x=CPTensor(weights.to(op.device), _lift_pieces(op_c, state.V, Y, niter)),
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
