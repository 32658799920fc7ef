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

The steps are written once, over shard pieces (``parallel/krylov.py``): with
a ``ShardedOperator`` the basis is per-shard slabs ``(Kb, d_f, n_local)`` and
B its pieces ``(R, d_f, n_local)``; the block's SpMV is the sharded one of
op.comm, every n-sized sum (the CGS2 coefficients, the norms, the b̃ rows,
b's Gram) a per-piece partial summed by ``psum`` on the lead device, where
H, b̃ and the projected stage live; the lucky restart takes each piece's
columns of the whole. x_s = V_sᵀ Y_s runs per shard and is gathered. One
piece runs the unsharded operations, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .coeffs.tables import BHTables, load_tables
from .ops.orth import _TINY, KrylovState, _acc_dtype, _breakdown, _dot, _project, _replace_lucky, _sqrt_rn, _subtract
from .parallel.krylov import like, norms, pieces, psum, scatter, spmv_pieces
from .solver import (_check_block, _check_hess_eig_size, _check_identical_factors, _lift_pieces, _new_history,
                     _record_check, _resolve_config, _result, projected_step)
from .types import CPTensor, SolveResult, SolverConfig, Status

__all__ = ["solve_block", "block_krylov_step", "init_block_state"]


def _orthonormalize_column(op, V, u, c, B, proj_dtype):
    """CGS2 of u (d, n) against the basis columns < c, over pieces (V, u and
    B lists of per-piece tensors). Returns the coefficient column (d, c), the
    new unit vector's pieces in the compute dtype (the restart where it
    vanished), its norm (0 on breakdown) and the new b̃ row ⟨q, b_r⟩ (d, R)."""
    acc = _acc_dtype(V[0].dtype, proj_dtype)
    u = [x.to(acc) for x in u]
    w1 = _project(op, V, u, c, proj_dtype)
    u = _subtract(op, V, u, w1, c)
    w2 = _project(op, V, u, c, proj_dtype)
    u = _subtract(op, V, u, w2, c)
    h = w1 + w2

    h_new = _sqrt_rn(_dot(op, u, u).to(proj_dtype))
    h_new, lucky, safe = _breakdown(h_new, torch.sum(torch.abs(h), dim=1) + _TINY, acc)
    q = [x / sf.to(acc)[:, None] for x, sf in zip(u, scatter(op, safe))]
    if bool(lucky.any()):
        q = _replace_lucky(op, V, q, lucky, c, proj_dtype)
    bt_row = psum(op, [torch.einsum("dn,rdn->dr", qi, Bi.to(acc)) for qi, Bi in zip(q, B)]).to(proj_dtype)
    return h, q, h_new, bt_row


def init_block_state(op, B, kmax: int, R: int, proj_dtype, basis_dtype=None) -> Tuple[KrylovState, torch.Tensor]:
    """Orthonormalize the R starting vectors of every factor into V[0:R] and
    record their b̃ rows; returns (state, ‖b‖ of the whole rank-R RHS).

    State layout: V (Kb, d, n), H (d, Kb, Kb), b̃ (d, Kb, R), Kb = (kmax+1)·R.
    op and B: a KroneckerSumOperator and (R, d, n), or a ShardedOperator and
    B's pieces (R, d_f, n_local) (state.V is then the per-shard slabs).
    """
    Kb = (kmax + 1) * R
    dtype = basis_dtype if basis_dtype is not None else op.dtype
    acc = _acc_dtype(dtype, proj_dtype)
    Bs = [x.to(acc) for x in pieces(B)]
    V = [torch.zeros((Kb,) + tuple(x.shape[1:]), dtype=dtype, device=x.device) for x in Bs]
    Gb = psum(op, [torch.einsum("rdn,qdn->drq", x, x) for x in Bs]).to(proj_dtype)
    lead = Gb.device
    H = torch.zeros((op.d, Kb, Kb), dtype=proj_dtype, device=lead)
    btil = torch.zeros((op.d, Kb, R), dtype=proj_dtype, device=lead)
    for r in range(R):
        _, q, _, bt_row = _orthonormalize_column(op, V, [x[r] for x in Bs], r, Bs, proj_dtype)
        for Vi, qi in zip(V, q):
            Vi[r] = qi.to(dtype)
        btil[:, r, :] = bt_row
    b_norm = torch.sqrt(torch.clamp(torch.sum(torch.prod(Gb, dim=0)), min=0.0))
    return KrylovState(like(B, V), H, btil, torch.zeros((op.d,), dtype=proj_dtype, device=lead)), b_norm


def block_krylov_step(op, state: KrylovState, B, k: int, R: int, *, proj_dtype) -> KrylovState:
    """Block step k: basis columns [kR, (k+1)R) from A times block k−1, one
    SpMV of (d, R, n) (over pieces: the sharded SpMV of (d_f, R, n_local)),
    then R column-sequential CGS2 passes against the whole prefix. H, V and
    b̃ are written in place."""
    V, H, btil, _ = state
    Vs, Bs = pieces(V), pieces(B)
    kc = k * R
    acc = _acc_dtype(Vs[0].dtype, proj_dtype)
    U = spmv_pieces(op, [Vi[kc - R:kc].to(acc).transpose(0, 1).contiguous() for Vi in Vs])     # (d, R, n)
    for r in range(R):
        c = kc + r
        hcol, q, h_new, bt_row = _orthonormalize_column(op, Vs, [Ui[:, r, :] for Ui in U], c, Bs, proj_dtype)
        # H column c − R: the CGS coefficients and the norm at row c
        H[:, :c, c - R] = hcol
        H[:, c, c - R] = h_new
        for Vi, qi in zip(Vs, q):
            Vi[c] = qi.to(Vi.dtype)
        btil[:, c, :] = bt_row
    return KrylovState(V, H, btil, state.beta)


def _solve_block(op, B, tables: Optional[BHTables], config: SolverConfig, R: int) -> SolveResult:
    d, n = op.d, op.n
    K = config.kmax + 1
    pdt = config.proj_dtype
    dev = op.device
    op_c = op.astype(_acc_dtype(config.basis_dtype, pdt))
    state, b_norm = init_block_state(op_c, B, config.kmax, R, pdt, config.basis_dtype)
    # per-term RHS norms for the drift probe: (d, 1, R)
    Bn = norms(op, [x.to(pdt).transpose(0, 1) for x in pieces(B)], dim=2)[:, None, :] + _TINY

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
    # the basis columns built, (niter + 1)·R; the rest of V is zero
    return _result(CPTensor(weights, _lift_pieces(op, state.V, Y, (niter + 1) * R - 1)), status, niter, h, config)


def solve_block(op, B, config: Optional[SolverConfig] = None, tables: Optional[BHTables] = None) -> SolveResult:
    """Solve A x = b for a rank-R RHS b = Σ_r ⊗_s B[r, s] in one shared block
    Krylov subspace (global tensorized Krylov), on the operator's device.

    Args:
      B: (R, d, n), the factor vectors of each rank-1 RHS term.

    Returns a SolveResult whose x is a rank-(tmax·R) CPTensor;
    relative_residual is that of the whole rank-R system. `kmax` counts block
    iterations (each adds R basis vectors per factor).

    op may be a ShardedOperator (the JAX dry run's
    ``solve_block(shard_operator(op, mesh), B_sharded, cfg)``): B whole (it
    is split) or its pieces, ``shard_rhs(B, mesh, d)``; the block steps run
    over the pieces, the projected stage on the lead device, and x is
    gathered there.
    """
    config = _resolve_config(config or SolverConfig(), op)
    if config.eigh_impl == "tridiag_mixed":
        # block H is block-tridiagonal, not tridiagonal (JAX block.py:305-307)
        config = dataclasses.replace(config, eigh_impl="dense")
    B = _check_block(op, B)
    _check_identical_factors(config, op, B)
    R = pieces(B)[0].shape[0]
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
    if R == 1:                 # block Arnoldi's H has R subdiagonals: upper Hessenberg only here
        _check_hess_eig_size(op, config)
    return _solve_block(op, B, tables, config, R)
