"""Batched Lanczos steps: counterpart of ``tensorkrylov_tpu/ops/orth.py``.

The d factors are a leading batch axis: one step advances all d recurrences.
The basis keeps the JAX package's K-leading layout ``V (K, d, n)``, so each
step's basis write is one contiguous slab and ``V[:k]`` is the active prefix.

Where the JAX package keeps every array at its padded size and masks, the
port slices the active prefix ``V[:k]``, and it updates the state in place:
``lanczos_step`` writes column k of V, entries of H and b̃, and returns the
same tensors. The sweeps over the prefix are one strided batched product in
the compute dtype; the TPU's column chunking and emulated-f64 dot are not
needed on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..types import KroneckerSumOperator
from .banded import spmv
from .fused_lanczos import fixed_order_sum, fused_lanczos_core

__all__ = ["KrylovState", "init_state", "lanczos_step", "orthogonality_loss", "lanczos_algorithm"]


class KrylovState(NamedTuple):
    """Krylov decomposition state for all d factors (K = kmax + 1).

    V: (K, d, n) orthonormal bases, Krylov index leading.
    H: (d, K, K) projected matrices (proj dtype): H[s, i, j] = v_i^T A v_j.
    btil: (d, K) compressed RHS entries <v_j, b_s>.
    beta: (d,) last subdiagonal (the recurrence carry).
    """

    V: torch.Tensor
    H: torch.Tensor
    btil: torch.Tensor
    beta: torch.Tensor


def _acc_dtype(basis_dtype, proj_dtype):
    """Compute dtype of length-n work: the projected dtype when the basis is
    f64, else f32 (a narrower basis is promoted to f32 for arithmetic)."""
    return proj_dtype if basis_dtype == torch.float64 else torch.float32


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded √x. CUDA's sqrt is; torch's CPU sqrt is not always
    (about 1 value in 100 is 1 ulp off), and a recurrence that is not
    reorthogonalized amplifies that, so CPU tensors take numpy's IEEE sqrt."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched per-factor dot ⟨a_s, b_s⟩ over the last axis."""
    return torch.einsum("...n,...n->...", a, b)


def init_state(op: KroneckerSumOperator, b: torch.Tensor, kmax: int, proj_dtype, basis_dtype=None) -> Tuple[KrylovState, torch.Tensor]:
    """Normalize b per factor into V[0]; returns (state, b_norms (d,))."""
    d, n = b.shape
    K = kmax + 1
    dtype = basis_dtype if basis_dtype is not None else op.dtype
    acc = _acc_dtype(dtype, proj_dtype)
    b = b.to(acc)
    # the start's sums in the fused kernel's fixed order: a recurrence that is
    # not reorthogonalized amplifies their rounding, so it must start from the
    # same bits on every device
    b_norms = _sqrt_rn(fixed_order_sum(b * b)).to(proj_dtype)
    v0 = b / b_norms.to(acc)[:, None]
    V = torch.zeros((K, d, n), dtype=dtype, device=b.device)
    V[0] = v0.to(dtype)
    H = torch.zeros((d, K, K), dtype=proj_dtype, device=b.device)
    btil = torch.zeros((d, K), dtype=proj_dtype, device=b.device)
    btil[:, 0] = fixed_order_sum(v0 * b).to(proj_dtype)
    beta = torch.zeros((d,), dtype=proj_dtype, device=b.device)
    return KrylovState(V, H, btil, beta), b_norms


def _project_coeffs(V, u, k, proj_dtype):
    """w = V[:k]^T u per factor: (d, k)."""
    acc = _acc_dtype(V.dtype, proj_dtype)
    Vk = V[:k].to(acc).transpose(0, 1)                         # (d, k, n), strided
    return torch.bmm(Vk, u.to(acc)[:, :, None])[:, :, 0].to(proj_dtype)


def _subtract_span(V, u, w, k):
    """u − Σ_{j<k} w_j V[j], accumulated in u's (compute) dtype."""
    Vk = V[:k].to(u.dtype).permute(1, 2, 0)                    # (d, n, k), strided
    return u - torch.bmm(Vk, w.to(u.dtype)[:, :, None])[:, :, 0]


def _replace_lucky(V, v_new, lucky, k, proj_dtype):
    """Lucky-breakdown restart: for factors whose new Krylov vector vanished
    (the space is A-invariant), continue with a fixed pseudo-random direction
    orthogonalized twice against the basis; an exhausted space gets a zero
    column (A·0 = 0 and ⟨·,0⟩ = 0 keep it inert)."""
    K, d, n = V.shape
    cdt = _acc_dtype(V.dtype, proj_dtype)
    i = torch.arange(n, dtype=cdt, device=V.device)
    s = torch.arange(d, dtype=cdt, device=V.device)[:, None]
    vr = torch.cos((i[None, :] + 0.7) * (1.0 + 0.01 * s) + 0.37 * float(k))
    nrm0 = torch.sqrt(torch.sum(vr.to(proj_dtype) ** 2, dim=1))
    for _ in range(2):
        vr = _subtract_span(V, vr, _project_coeffs(V, vr, k, proj_dtype), k)
    nrm = torch.sqrt(torch.sum(vr.to(proj_dtype) ** 2, dim=1))
    ok = nrm > 2.0**-12 * nrm0
    vr = torch.where(ok[:, None], vr / torch.where(nrm > 0, nrm, 1.0).to(vr.dtype)[:, None], 0.0)
    return torch.where(lucky[:, None], vr.to(v_new.dtype), v_new)


def lanczos_step(op: KroneckerSumOperator, state: KrylovState, b: torch.Tensor, k: int, *, reorth, proj_dtype, fused: bool = False, reorth_tol: float = 0.0):
    """One three-term-recurrence step producing basis vector k for all
    factors. Returns (state, orthogonality-loss estimate); the state's
    tensors are updated in place.

    reorth: False (plain) | True (always one extra classical Gram–Schmidt
    sweep over V[:k]) | 'auto' (the sweep runs when the drift probe
    |⟨v_k, v_0⟩| = |⟨u, b⟩|/(β‖b_s‖) exceeds reorth_tol, or √eps of the
    compute dtype when reorth_tol is 0).

    fused=True computes the recurrence core (SpMV, the α/β updates and the
    α, β², ⟨u, b⟩ sums) with ops.fused_lanczos in plain and auto modes.
    """
    V, H, btil, beta = state
    acc = _acc_dtype(V.dtype, proj_dtype)
    mode = "auto" if reorth == "auto" else ("always" if reorth else "plain")
    v_prev = V[k - 1].to(acc)
    v_pprev = V[max(k - 2, 0)].to(acc)
    b = b.to(acc)

    loss = None
    if fused and mode != "always":
        u, alpha, beta_sq, ub = fused_lanczos_core(op, v_prev, v_pprev, beta.to(acc), b)
        alpha, beta_sq, ub = alpha.to(proj_dtype), beta_sq.to(proj_dtype), ub.to(proj_dtype)
    else:
        u = spmv(op, v_prev)
        # beta is zero at k == 1, so v_pprev = V[0] contributes nothing
        u = u - beta.to(acc)[:, None] * v_pprev
        alpha = bdot(u, v_prev).to(proj_dtype)
        u = u - alpha.to(acc)[:, None] * v_prev
        if mode == "always":
            w = _project_coeffs(V, u, k, proj_dtype)
            u = _subtract_span(V, u, w, k)
            loss = torch.linalg.vector_norm(w)
        beta_sq = bdot(u, u).to(proj_dtype)
        ub = bdot(u, b).to(proj_dtype)

    # v_0-drift probe |⟨u, b⟩|/(β‖b_s‖) = |⟨v_k, v_0⟩| (b̃[:, 0] = ‖b_s‖)
    tiny = 1e-300
    beta_pre = torch.sqrt(torch.clamp(beta_sq, min=tiny))
    probe = torch.max(torch.abs(ub) / (btil[:, 0] * beta_pre + tiny))
    if loss is None:
        loss = probe

    if mode == "auto":
        thresh = reorth_tol if reorth_tol > 0.0 else math.sqrt(torch.finfo(acc).eps)
        if bool(probe > thresh):
            u = _subtract_span(V, u, _project_coeffs(V, u, k, proj_dtype), k)
            beta_sq = bdot(u, u).to(proj_dtype)
            ub = bdot(u, b).to(proj_dtype)

    beta_new = _sqrt_rn(torch.clamp(beta_sq, min=0.0))
    # lucky breakdown: the factor's Krylov space is invariant; β stays 0 in H
    scale = torch.abs(alpha) + beta + tiny
    lucky = beta_new < 256.0 * torch.finfo(u.dtype).eps * scale
    beta_new = torch.where(lucky, 0.0, beta_new)
    safe = torch.where(beta_new > 0, beta_new, 1.0)
    v_new = u / safe.to(u.dtype)[:, None]
    # b̃_k = ⟨u/β, b⟩ = ub/β; a restart replaced v_new, so recompute it then
    bt_new = ub / safe
    if bool(lucky.any()):
        v_new = _replace_lucky(V, v_new, lucky, k, proj_dtype)
        bt_new = bdot(v_new, b.to(u.dtype)).to(proj_dtype)

    V[k] = v_new.to(V.dtype)
    H[:, k - 1, k - 1] = alpha
    H[:, k, k - 1] = beta_new
    H[:, k - 1, k] = beta_new
    btil[:, k] = bt_new
    return KrylovState(V, H, btil, beta_new), loss


def lanczos_algorithm(op: KroneckerSumOperator, b, k: int, *, reorth: bool = False, proj_dtype=torch.float64) -> KrylovState:
    """Run k Lanczos steps for every factor. b: (d, n) or (n,)."""
    if b.dim() == 1:
        b = b[None, :]
    state, _ = init_state(op, b, k, proj_dtype)
    for j in range(1, k + 1):
        state, _ = lanczos_step(op, state, b, j, reorth=reorth, proj_dtype=proj_dtype)
    return state


def orthogonality_loss(V: torch.Tensor, k: int, proj_dtype=torch.float64) -> torch.Tensor:
    """‖V_kᵀ V_k − I‖_F over the active prefix, maximized over factors."""
    Vk = V[:k].to(proj_dtype)
    G = torch.einsum("kdn,ldn->dkl", Vk, Vk)
    E = G - torch.eye(k, dtype=proj_dtype, device=V.device)
    return torch.max(torch.sqrt(torch.sum(E * E, dim=(1, 2))))
