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
with the fused step. Both passes start from ``ops/orth.py:init_state``'s v_0.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .coeffs.tables import BHTables, load_tables
from .ops.banded import spmv
from .ops.eigen import dense_minor_window
from .ops.fused_lanczos import fixed_order_sum, fused_lanczos_core
from .ops.orth import _TINY, _acc_dtype, _breakdown, _sqrt_rn, bdot
from .solver import _History, _new_history, _record_check, _resolve_config, _result, projected_step
from .types import CPTensor, KroneckerSumOperator, SolveResult, SolverConfig, Status

__all__ = ["solve_two_pass"]


class _Start(NamedTuple):
    v0: torch.Tensor       # (d, n) compute dtype
    b: torch.Tensor        # (d, n) compute dtype
    b_norms: torch.Tensor  # (d,) proj dtype
    bt0: torch.Tensor      # (d,) ⟨v_0, b⟩


def _start(b: torch.Tensor, acc, pdt) -> _Start:
    """v_0 = b/‖b_s‖ with init_state's sums and square root, so that both
    passes, and solve, start from the same bits."""
    b = b.to(acc)
    b_norms = _sqrt_rn(fixed_order_sum(b * b)).to(pdt)
    v0 = b / b_norms.to(acc)[:, None]
    return _Start(v0, b, b_norms, fixed_order_sum(v0 * b).to(pdt))


def _recurrence_step(op, v_prev, v_pprev, beta, b_acc, pdt, fused: bool = False):
    """One basis-free Lanczos step: lanczos_step's arithmetic in plain mode
    without the basis write. Returns (v_new, alpha, beta_new, bt) with
    bt = ⟨v_new, b⟩."""
    if fused:
        u, alpha, beta_sq, ub = fused_lanczos_core(op, v_prev, v_pprev, beta.to(v_prev.dtype), b_acc)
        alpha, beta_sq, ub = alpha.to(pdt), beta_sq.to(pdt), ub.to(pdt)
    else:
        u = spmv(op, v_prev)
        u = u - beta.to(u.dtype)[:, None] * v_pprev
        alpha = bdot(u, v_prev).to(pdt)
        u = u - alpha.to(u.dtype)[:, None] * v_prev
        beta_sq, ub = bdot(u, u).to(pdt), None
    beta_new, lucky, safe = _breakdown(_sqrt_rn(torch.clamp(beta_sq, min=0.0)), torch.abs(alpha) + beta + _TINY,
                                       u.dtype)
    v_new = torch.where(lucky[:, None], 0.0, u / safe.to(u.dtype)[:, None])
    if ub is None:
        bt = bdot(v_new, b_acc).to(pdt)
    else:
        # b̃_k = ⟨u/β, b⟩ = ub/β; a lucky factor's v_new is the zero vector
        bt = torch.where(lucky, 0.0, ub / safe)
    return v_new, alpha, beta_new, bt


class _Pass1(NamedTuple):
    H: torch.Tensor
    k: int
    status: int
    weights: torch.Tensor
    Y: torch.Tensor
    history: _History


def _pass1(op: KroneckerSumOperator, st: _Start, tables, config: SolverConfig) -> _Pass1:
    d, n = st.b.shape
    K = config.kmax + 1
    pdt = config.proj_dtype
    dev = op.device
    fused = config.step_impl == "fused"
    W_A = dense_minor_window(op, K).to(pdt) if config.spectral_source == "A_minor" else None
    b_norm_prod = torch.prod(st.b_norms)

    H = torch.zeros((d, K, K), dtype=pdt, device=dev)
    btil = torch.zeros((d, K), dtype=pdt, device=dev)
    btil[:, 0] = st.bt0
    weights = torch.zeros((config.tmax,), dtype=pdt, device=dev)
    Y = torch.zeros((d, K, config.tmax), dtype=pdt, device=dev)
    h = _new_history(K, pdt, dev)
    v_prev, v_pprev, beta = st.v0, torch.zeros_like(st.v0), torch.zeros((d,), dtype=pdt, device=dev)
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


def _lift_pass2(op: KroneckerSumOperator, st: _Start, H, Y, k_star: int, pdt) -> torch.Tensor:
    """Regenerate v_0..v_{k*} from the recorded α and β and accumulate
    X_s = Σ_j v_j · Y_s[j, :], the lift V_s Y_s without a stored basis."""
    acc = st.v0.dtype
    d = st.v0.shape[0]
    Ya = Y.to(acc)
    X = st.v0[:, :, None] * Ya[:, 0, None, :]                           # (d, n, T)
    v_prev, v_pprev = st.v0, torch.zeros_like(st.v0)
    for j in range(1, k_star + 1):
        # recorded coefficients: α_j = H[j-1, j-1], β entering = H[j-1, j-2]
        # (0 for j == 1), new β_j = H[j, j-1]
        alpha = H[:, j - 1, j - 1]
        beta_in = H[:, j - 1, j - 2] if j > 1 else torch.zeros((d,), dtype=pdt, device=H.device)
        beta_out = H[:, j, j - 1]
        u = spmv(op, v_prev)
        u = u - beta_in.to(acc)[:, None] * v_pprev
        u = u - alpha.to(acc)[:, None] * v_prev
        safe = torch.where(beta_out > 0, beta_out, 1.0)
        v_new = torch.where((beta_out > 0)[:, None], u / safe.to(acc)[:, None], 0.0)
        X.addcmul_(v_new[:, :, None], Ya[:, j, None, :])
        v_prev, v_pprev = v_new, v_prev
    return X.to(pdt)


def solve_two_pass(op: KroneckerSumOperator, b, config: Optional[SolverConfig] = None,
                   tables: Optional[BHTables] = None) -> SolveResult:
    """Basis-free tensorized Lanczos solve (two passes, O(d·n) basis memory)
    on the operator's device.

    Same result contract as `solve`; requires a symmetric operator and
    orth='lanczos' (pass `SolverConfig(orth="lanczos")`).
    """
    config = config or SolverConfig(orth="lanczos")
    if not op.symmetric:
        raise ValueError("solve_two_pass requires a symmetric operator")
    if config.orth != "lanczos":
        raise ValueError("solve_two_pass supports plain Lanczos only "
                         "(reorthogonalization/Arnoldi need the stored basis)")
    config = _resolve_config(config, op)
    b = torch.as_tensor(b, device=op.device)
    if b.dim() != 2 or b.shape[0] != op.d or b.shape[1] != op.n:
        raise ValueError(f"b must be (d, n) = ({op.d}, {op.n}), got {tuple(b.shape)}")
    pdt = config.proj_dtype
    if tables is None:
        tables = load_tables(dtype=pdt, device=op.device)
    acc = _acc_dtype(config.basis_dtype, pdt)
    op_c = op.astype(acc)

    p1 = _pass1(op_c, _start(b, acc, pdt), tables, config)
    niter = p1.k - 1
    X = _lift_pass2(op_c, _start(b, acc, pdt), p1.H, p1.Y, niter, pdt)
    return _result(CPTensor(p1.weights, X), p1.status, niter, p1.history, config)
