"""Two-pass (basis-free) tensorized Lanczos solve, O(d·n) basis memory:
counterpart of ``tensorkrylov_tpu/twopass.py``.

``solve`` stores the whole Krylov basis V (K, d, n) for the final lift
x_s = V_s y_s. Here:

  pass 1 — the three-term recurrence keeps only (v_{k-1}, v_{k-2}); H and b̃
           are the only growing state, and the projected stage is the same
           ``projected_step`` as ``solve``'s;
  pass 2 — after the last step k*, the basis vectors are regenerated one at a
           time from the recorded α and β (u = A v_{j-1} − β_{j-1} v_{j-2} −
           α_j v_{j-1}, v_j = u/β_j, no reductions) and the factors
           accumulate X_s += v_j · Y_s[j, :].

Memory O(d·n·(3 + t) + d·k²) instead of O(d·n·K), for one more sweep of SpMVs.
Plain Lanczos and symmetric operators only (reorthogonalization and Arnoldi
need the basis); a lucky breakdown writes the zero vector.

With ``step_impl='fused'`` pass 1's recurrence core is
``ops.fused_lanczos.fused_lanczos_core``, in f32 and f64 (the JAX package fuses
only an f32 compute dtype), and the α and β it records are those of ``solve``
with the fused step. Both passes start from ``ops/orth.py:unit_start``'s v_0,
as ``init_state`` does.

Both passes are written over shard pieces (``parallel/krylov.py``): with a
``ShardedOperator`` (the JAX dry run's ``solve_two_pass(shard_operator(op,
mesh), shard_rhs(b, mesh), cfg)``) the live vectors and b are per-shard
slabs, the SpMV is the sharded one of op.comm, pass 1's dots are psums on
the lead device (where H, b̃ and the projected stage live), and pass 2
accumulates X per piece (``deflate_light.accumulate_replay``, the deflated
replay's accumulation) and gathers it. The fused core sums over one whole
piece, so a ShardedOperator takes the unfused step. One piece runs the
unsharded operations, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .coeffs.tables import BHTables, load_tables
from .deflate_light import accumulate_replay
from .ops.fused_lanczos import fused_lanczos_core
from .ops.orth import _TINY, _acc_dtype, _breakdown, _dot, _sqrt_rn, unit_start
from .parallel.krylov import like, pieces, scatter, spmv_pieces, whole
from .solver import (_check_problem, _History, _minor_window, _new_history, _record_check, _resolve_config, _result,
                     projected_step)
from .types import CPTensor, SolveResult, SolverConfig, Status

__all__ = ["solve_two_pass"]


class _Start(NamedTuple):
    v0: torch.Tensor       # (d, n) compute dtype (or its pieces)
    b: torch.Tensor        # (d, n) compute dtype (or its pieces)
    b_norms: torch.Tensor  # (d,) proj dtype
    bt0: torch.Tensor      # (d,) ⟨v_0, b⟩


def _start(b, acc, pdt, op=None) -> _Start:
    """v_0 = b/‖b_s‖ by ops/orth.unit_start, init_state's sums and square
    root, so that both passes, and solve, start from the same bits. b is
    (d, n), or its pieces with op the ShardedOperator."""
    bs = [x.to(acc) for x in pieces(b)]
    v0, b_norms, bt0 = unit_start(op, bs, pdt)
    return _Start(like(b, v0), like(b, bs), b_norms, bt0)


def _recurrence_step(op, v_prev, v_pprev, beta, b_acc, pdt, fused: bool = False):
    """One basis-free Lanczos step: lanczos_step's arithmetic in plain mode
    without the basis write, over pieces (the vectors and b_acc tensors, or
    lists of pieces with op a ShardedOperator; fused takes one piece).
    Returns (v_new, alpha, beta_new, bt) with bt = ⟨v_new, b⟩."""
    vp, vpp, bs = pieces(v_prev), pieces(v_pprev), pieces(b_acc)
    if fused:
        u, alpha, beta_sq, ub = fused_lanczos_core(op, vp[0], vpp[0], beta.to(vp[0].dtype), bs[0])
        u = [u]
        alpha, beta_sq, ub = alpha.to(pdt), beta_sq.to(pdt), ub.to(pdt)
    else:
        u = spmv_pieces(op, vp)
        u = [ui - bt[:, None] * x for ui, bt, x in zip(u, scatter(op, beta.to(u[0].dtype)), vpp)]
        alpha = _dot(op, u, vp).to(pdt)
        u = [ui - a[:, None] * x for ui, a, x in zip(u, scatter(op, alpha.to(u[0].dtype)), vp)]
        beta_sq, ub = _dot(op, u, u).to(pdt), None
    cdt = u[0].dtype
    beta_new, lucky, safe = _breakdown(_sqrt_rn(torch.clamp(beta_sq, min=0.0)), torch.abs(alpha) + beta + _TINY, cdt)
    v_new = [torch.where(lk[:, None], 0.0, ui / sf.to(cdt)[:, None])
             for ui, lk, sf in zip(u, scatter(op, lucky), scatter(op, safe))]
    if ub is None:
        bt = _dot(op, v_new, bs).to(pdt)
    else:
        # b̃_k = ⟨u/β, b⟩ = ub/β; a lucky factor's v_new is the zero vector
        bt = torch.where(lucky, 0.0, ub / safe)
    return like(v_prev, v_new), alpha, beta_new, bt


class _Pass1(NamedTuple):
    H: torch.Tensor
    k: int
    status: int
    weights: torch.Tensor
    Y: torch.Tensor
    history: _History


def _pass1(op, st: _Start, tables, config: SolverConfig) -> _Pass1:
    d, n = op.d, op.n
    K = config.kmax + 1
    pdt = config.proj_dtype
    dev = op.device
    fused = config.step_impl == "fused"
    W_A = _minor_window(op, K).to(pdt) if config.spectral_source == "A_minor" else None
    b_norm_prod = torch.prod(st.b_norms)

    H = torch.zeros((d, K, K), dtype=pdt, device=dev)
    btil = torch.zeros((d, K), dtype=pdt, device=dev)
    btil[:, 0] = st.bt0
    weights = torch.zeros((config.tmax,), dtype=pdt, device=dev)
    Y = torch.zeros((d, K, config.tmax), dtype=pdt, device=dev)
    h = _new_history(K, pdt, dev)
    v_prev, beta = st.v0, torch.zeros((d,), dtype=pdt, device=dev)
    v_pprev = like(st.v0, [torch.zeros_like(v) for v in pieces(st.v0)])
    status, k = Status.RUNNING, 1
    while k <= config.kmax and status == Status.RUNNING:
        v_new, alpha, beta_new, bt = _recurrence_step(op, v_prev, v_pprev, beta, st.b, pdt, fused)
        H[:, k - 1, k - 1] = alpha
        H[:, k, k - 1] = beta_new
        H[:, k - 1, k] = beta_new
        btil[:, k] = bt
        # v_0-drift probe |⟨v_k, v_0⟩| = |b̃_k|/‖b_s‖
        h.orth[k] = torch.max(torch.abs(bt) / (st.b_norms + _TINY))
        if k % config.check_every == 0 or k >= config.kmax:
            ev = projected_step(H, btil, H[:, k, k - 1], k, b_norm_prod, config, tables, op.symmetric, n, W_A)
            status = _record_check(h, k, ev, config)
            # on breakdown the projected solution is untrustworthy: keep the previous one
            if status != Status.BREAKDOWN:
                weights, Y = ev.weights, ev.Y
        v_prev, v_pprev, beta = v_new, v_prev, beta_new
        k += 1
    return _Pass1(H, k, int(status), weights, Y, h)


def _lift_pass2(op, st: _Start, H, Y, k_star: int, pdt):
    """Regenerate v_0..v_{k*} from the recorded α and β (no reductions) and
    accumulate X_s = Σ_j v_j · Y_s[j, :] (deflate_light.accumulate_replay),
    the lift V_s Y_s without a stored basis; over pieces X is per piece."""
    v0 = pieces(st.v0)
    acc, d = v0[0].dtype, op.d
    vp, vpp = v0, [torch.zeros_like(v) for v in v0]

    def regenerate(j):
        nonlocal vp, vpp
        # recorded coefficients: α_j = H[j-1, j-1], β entering = H[j-1, j-2]
        # (0 for j == 1), new β_j = H[j, j-1]
        alpha = H[:, j - 1, j - 1]
        beta_in = H[:, j - 1, j - 2] if j > 1 else torch.zeros((d,), dtype=pdt, device=H.device)
        beta_out = H[:, j, j - 1]
        u = spmv_pieces(op, vp)
        u = [ui - b[:, None] * x for ui, b, x in zip(u, scatter(op, beta_in.to(acc)), vpp)]
        u = [ui - a[:, None] * x for ui, a, x in zip(u, scatter(op, alpha.to(acc)), vp)]
        safe = torch.where(beta_out > 0, beta_out, 1.0)
        v_new = [torch.where(pos[:, None], ui / sf.to(acc)[:, None], 0.0)
                 for ui, pos, sf in zip(u, scatter(op, beta_out > 0), scatter(op, safe))]
        vp, vpp = v_new, vp
        return v_new

    X, _ = accumulate_replay(op, v0, Y.to(acc), k_star, regenerate)
    return like(st.v0, [Xi.to(pdt) for Xi in X])


def solve_two_pass(op, b, config: Optional[SolverConfig] = None,
                   tables: Optional[BHTables] = None) -> SolveResult:
    """Basis-free tensorized Lanczos solve (two passes, O(d·n) basis memory)
    on the operator's device.

    Same result contract as `solve`; requires a symmetric operator and
    orth='lanczos' (pass `SolverConfig(orth="lanczos")`). op may be a
    ShardedOperator, b then whole or its pieces (shard_rhs); x is gathered
    to the lead device.
    """
    config = config or SolverConfig(orth="lanczos")
    if not op.symmetric:
        raise ValueError("solve_two_pass requires a symmetric operator")
    if config.orth != "lanczos":
        raise ValueError("solve_two_pass supports plain Lanczos only "
                         "(reorthogonalization/Arnoldi need the stored basis)")
    config = _resolve_config(config, op)
    b = _check_problem(op, b, config)
    pdt = config.proj_dtype
    if tables is None:
        tables = load_tables(dtype=pdt, device=op.device)
    acc = _acc_dtype(config.basis_dtype, pdt)
    op_c = op.astype(acc)

    p1 = _pass1(op_c, _start(b, acc, pdt, op_c), tables, config)
    niter = p1.k - 1
    X = _lift_pass2(op_c, _start(b, acc, pdt, op_c), p1.H, p1.Y, niter, pdt)
    return _result(CPTensor(p1.weights, whole(op_c, X, axis=1)), p1.status, niter, p1.history, config)
