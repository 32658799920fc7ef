"""Block (global) tensorized Krylov for a rank-R tensor-product right-hand
side: counterpart of ``tensorkrylov_tpu/block.py``.

Solves A x = b with b = Σ_{r=1..R} ⊗_s b_{s,r} in one shared block Krylov
subspace per factor, K_k(A_s, [b_{s,1} … b_{s,R}]):

  * per factor, the orthonormal basis grows by R columns per block step: one
    banded SpMV of the previous block (d, R, n), then column-sequential CGS2
    against the whole prefix (block Arnoldi with full orthogonalization; for
    SPD factors H_s comes out block tridiagonal);
  * the projected system (Σ_s ⊕ H_s) y = Σ_r ⊗_s b̃_{s,r} goes through the
    same ``projected_step`` as ``solve``, with b̃ (d, K, R) and the boundary
    block B_s = H_s[kR:(k+1)R, (k-1)R:kR] for the block Lemma 3.4;
  * a new column that falls inside the current space is replaced by the
    lucky-breakdown restart of ``ops/orth.py``, so the basis stays full rank.

As in ``solve``, the iteration is a host loop on the operator's device, the
projected stage every ``check_every`` block steps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .coeffs.tables import BHTables, load_tables
from .ops.banded import spmv
from .ops.orth import (_TINY, KrylovState, _acc_dtype, _breakdown, _project_coeffs, _replace_lucky, _sqrt_rn,
                       _subtract_span, bdot)
from .solver import _check_identical_factors, _new_history, _record_check, _resolve_config, _result, projected_step
from .types import CPTensor, KroneckerSumOperator, SolveResult, SolverConfig, Status

__all__ = ["solve_block", "block_krylov_step", "init_block_state"]


def _orthonormalize_column(V, u, c, B, proj_dtype):
    """CGS2 of u (d, n) against the basis columns < c. Returns the coefficient
    column (d, c), the new unit vector in the compute dtype (the restart where
    it vanished), its norm (0 on breakdown) and the new b̃ row ⟨q, b_r⟩ (d, R)."""
    acc = _acc_dtype(V.dtype, proj_dtype)
    u = u.to(acc)
    w1 = _project_coeffs(V, u, c, proj_dtype)
    u = _subtract_span(V, u, w1, c)
    w2 = _project_coeffs(V, u, c, proj_dtype)
    u = _subtract_span(V, u, w2, c)
    h = w1 + w2

    h_new = _sqrt_rn(bdot(u, u).to(proj_dtype))
    h_new, lucky, safe = _breakdown(h_new, torch.sum(torch.abs(h), dim=1) + _TINY, acc)
    q = u / safe.to(acc)[:, None]
    if bool(lucky.any()):
        q = _replace_lucky(None, [V], [q], lucky, c, proj_dtype)[0]
    bt_row = torch.einsum("dn,rdn->dr", q, B.to(acc)).to(proj_dtype)
    return h, q, h_new, bt_row


def init_block_state(op: KroneckerSumOperator, B: torch.Tensor, kmax: int, R: int, proj_dtype,
                     basis_dtype=None) -> Tuple[KrylovState, torch.Tensor]:
    """Orthonormalize the R starting vectors of every factor into V[0:R] and
    record their b̃ rows; returns (state, ‖b‖ of the whole rank-R RHS).

    State layout: V (Kb, d, n), H (d, Kb, Kb), b̃ (d, Kb, R), Kb = (kmax+1)·R.
    """
    d, n = B.shape[1], B.shape[2]
    Kb = (kmax + 1) * R
    dtype = basis_dtype if basis_dtype is not None else op.dtype
    acc = _acc_dtype(dtype, proj_dtype)
    B = B.to(acc)
    V = torch.zeros((Kb, d, n), dtype=dtype, device=B.device)
    H = torch.zeros((d, Kb, Kb), dtype=proj_dtype, device=B.device)
    btil = torch.zeros((d, Kb, R), dtype=proj_dtype, device=B.device)
    for r in range(R):
        _, q, _, bt_row = _orthonormalize_column(V, B[r], r, B, proj_dtype)
        V[r] = q.to(dtype)
        btil[:, r, :] = bt_row
    Gb = torch.einsum("rdn,qdn->drq", B, B).to(proj_dtype)
    b_norm = torch.sqrt(torch.clamp(torch.sum(torch.prod(Gb, dim=0)), min=0.0))
    return KrylovState(V, H, btil, torch.zeros((d,), dtype=proj_dtype, device=B.device)), b_norm


def block_krylov_step(op: KroneckerSumOperator, state: KrylovState, B: torch.Tensor, k: int, R: int, *,
                      proj_dtype) -> KrylovState:
    """Block step k: basis columns [kR, (k+1)R) from A times block k−1, one
    banded SpMV of (d, R, n), then R column-sequential CGS2 passes against the
    whole prefix. H, V and b̃ are written in place."""
    V, H, btil, _ = state
    kc = k * R
    acc = _acc_dtype(V.dtype, proj_dtype)
    U = spmv(op, V[kc - R:kc].to(acc).transpose(0, 1).contiguous())     # (d, R, n)
    for r in range(R):
        c = kc + r
        hcol, q, h_new, bt_row = _orthonormalize_column(V, U[:, r, :], c, B, proj_dtype)
        # H column c − R: the CGS coefficients and the norm at row c
        H[:, :c, c - R] = hcol
        H[:, c, c - R] = h_new
        V[c] = q.to(V.dtype)
        btil[:, c, :] = bt_row
    return KrylovState(V, H, btil, state.beta)


def _solve_block(op: KroneckerSumOperator, B: torch.Tensor, tables: Optional[BHTables], config: SolverConfig,
                 R: int) -> SolveResult:
    d, n = B.shape[1], B.shape[2]
    K = config.kmax + 1
    pdt = config.proj_dtype
    dev = op.device
    op_c = op.astype(_acc_dtype(config.basis_dtype, pdt))
    state, b_norm = init_block_state(op_c, B, config.kmax, R, pdt, config.basis_dtype)
    # per-term RHS norms for the drift probe: (d, 1, R)
    Bn = torch.linalg.vector_norm(B.to(pdt), dim=2).transpose(0, 1)[:, None, :] + _TINY

    weights = torch.zeros((config.tmax * R,), dtype=pdt, device=dev)
    Y = torch.zeros((d, K * R, config.tmax * R), dtype=pdt, device=dev)
    h = _new_history(K, pdt, dev)
    status, k = Status.RUNNING, 1
    while k <= config.kmax and status == Status.RUNNING:
        state = block_krylov_step(op_c, state, B, k, R, proj_dtype=pdt)
        kc = k * R
        # drift probe: the new block's b̃ rows ⟨q, b_r⟩ are 0 in exact
        # arithmetic for k ≥ 1 (the b_r span block 0)
        h.orth[k] = torch.max(torch.abs(state.btil[:, kc:kc + R, :]) / Bn)
        if k % config.check_every == 0 or k >= config.kmax:
            ev = projected_step(state.H, state.btil, state.H[:, kc:kc + R, kc - R:kc], kc, b_norm, config, tables,
                                op.symmetric, n, None)
            status = _record_check(h, k, ev, config)
            # on breakdown the projected solution is untrustworthy: keep the previous one
            if status != Status.BREAKDOWN:
                weights, Y = ev.weights, ev.Y
        k += 1

    niter = k - 1
    m = (niter + 1) * R   # the basis columns built; the rest of V is zero
    return _result(CPTensor(weights, torch.bmm(state.V[:m].to(pdt).permute(1, 2, 0), Y[:, :m])), status, niter, h,
                   config)


def solve_block(op: KroneckerSumOperator, B, config: Optional[SolverConfig] = None,
                tables: Optional[BHTables] = None) -> SolveResult:
    """Solve A x = b for a rank-R RHS b = Σ_r ⊗_s B[r, s] in one shared block
    Krylov subspace (global tensorized Krylov), on the operator's device.

    Args:
      B: (R, d, n), the factor vectors of each rank-1 RHS term.

    Returns a SolveResult whose x is a rank-(tmax·R) CPTensor;
    relative_residual is that of the whole rank-R system. `kmax` counts block
    iterations (each adds R basis vectors per factor).
    """
    config = _resolve_config(config or SolverConfig(), op)
    B = torch.as_tensor(B, device=op.device)
    if B.dim() != 3 or B.shape[1] != op.d or B.shape[2] != op.n:
        raise ValueError(f"B must be (R, d, n) = (R, {op.d}, {op.n}), got {tuple(B.shape)}")
    _check_identical_factors(config, op, B)
    R = B.shape[0]
    if not op.symmetric and config.orth != "arnoldi":
        raise ValueError("nonsymmetric operators require orth='arnoldi'")
    if config.spectral_source == "analytic_laplace":
        raise ValueError("block solves need spectral_source 'H' or 'A_minor'")
    if op.symmetric and tables is None:
        tables = load_tables(dtype=config.proj_dtype, device=op.device)
    # each factor's space has dimension n: at k·R = n active columns the
    # Galerkin solve is exact, and further steps would only add exhausted columns
    if config.kmax * R > op.n:
        config = dataclasses.replace(config, kmax=max(op.n // R, 1))
    return _solve_block(op, B, tables, config, R)
