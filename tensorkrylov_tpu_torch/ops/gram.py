"""Low-rank (Lemma 3.4) residual-norm algebra: counterpart of
``tensorkrylov_tpu/ops/gram.py``.

‖r‖² = Σ_s |h^{(s)}_{k+1,k}|²·‖y_𝔏‖²_s + ‖H y − b̃‖² for a CP tensor y, with
nothing of size k^d materialized. Everything here is f64: ‖Hy‖² − 2⟨Hy,b̃⟩ +
‖b̃‖² is catastrophically cancellative. The mode reductions use the same
combine functions in the same tree order as the JAX package's
``lax.associative_scan``, so both packages round alike.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import torch

__all__ = [
    "ResidualTerms",
    "cp_gram_matrices",
    "mv_norm_sq",
    "tensor_inner_prod",
    "residual_norm_sq",
    "excluded_products",
]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = torch.empty((even.shape[0] + odd.shape[0],) + even.shape[1:], dtype=even.dtype, device=even.device)
    out[0::2] = even
    out[1::2] = odd
    return out


def _associative_scan(combine: Callable, elems: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Inclusive scan over dim 0 in the odd/even recursion of
    ``jax.lax.associative_scan``: the same combines of the same operands."""
    num = elems[0].shape[0]
    if num < 2:
        return list(elems)
    reduced = combine([e[0:-1:2] for e in elems], [e[1::2] for e in elems])
    odd = _associative_scan(combine, reduced)
    if num % 2 == 0:
        even = combine([e[:-1] for e in odd], [e[2::2] for e in elems])
    else:
        even = combine(odd, [e[2::2] for e in elems])
    even = [torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _mask_yz(H, Y, btil, k):
    K = H.shape[1]
    m = (torch.arange(K, device=H.device) < k).to(H.dtype)
    Hm = H * m[None, :, None] * m[None, None, :]
    btil_m = btil * m[None, :] if btil.dim() == 2 else btil * m[None, :, None]  # rank-1 or block (d, K, R)
    return Hm, Y * m[None, :, None], btil_m


def cp_gram_matrices(Hm, Ym):
    """Z = H_s Y_s and the three t×t Gram families (all (d, t, t))."""
    Z = torch.einsum("dij,djt->dit", Hm, Ym)
    Gy = torch.einsum("dkt,dks->dts", Ym, Ym)
    Gz = torch.einsum("dkt,dks->dts", Z, Z)
    X = torch.einsum("dkt,dks->dts", Ym, Z)  # X[i,j] = <y_i, H y_j>
    return Z, Gy, Gz, X


def mv_norm_sq(Gy, Gz, X, weights):
    """‖H y‖² via the transfer composition over modes: the carry map of one
    mode is linear with elementwise t×t coefficients (g, a, b, c, e), and
    compositions stay in that family."""
    def combine(m1, m2):
        g1, a1, b1, c1, e1 = m1
        g2, a2, b2, c2, e2 = m2
        return [
            g2 * g1,
            a2 * g1 + g2 * a1,
            b2 * g1 + g2 * b1,
            c2 * g1 + g2 * c1,
            b2 * a1 + a2 * b1 + g2 * e1 + e2 * g1,
        ]

    g, a, b, c, e = _associative_scan(combine, [Gy, X.transpose(1, 2), X, Gz, torch.zeros_like(Gy)])
    T = e[-1] + c[-1]
    return weights @ T @ weights


def tensor_inner_prod(Ym, Z, btil_m, weights):
    """⟨H y, b̃⟩ via the single-excluded-index scan, for a rank-1 b̃ (d, K)
    or a rank-R block b̃ (d, K, R) (summed over its R terms)."""
    if btil_m.dim() == 2:
        g = torch.einsum("dkt,dk->dt", Ym, btil_m)  # <y_i, b̃>_m
        a = torch.einsum("dkt,dk->dt", Z, btil_m)   # <H y_i, b̃>_m
    else:
        g = torch.einsum("dkt,dkr->dtr", Ym, btil_m)  # <y_i, b̃_r>_m
        a = torch.einsum("dkt,dkr->dtr", Z, btil_m)   # <H y_i, b̃_r>_m

    def combine(m1, m2):
        g1, a1 = m1
        g2, a2 = m2
        return [g2 * g1, a2 * g1 + g2 * a1]

    _, ac = _associative_scan(combine, [g, a])
    return weights @ (ac[-1] if btil_m.dim() == 2 else torch.sum(ac[-1], dim=1))


def excluded_products(Gy):
    """E_s = Π_{m≠s} Gy_m elementwise, via exclusive forward/backward
    cumulative products (division-free). (d, t, t)."""
    ones = torch.ones_like(Gy[:1])
    pre = torch.cat([ones, torch.cumprod(Gy, dim=0)[:-1]], dim=0)
    rev = torch.flip(torch.cumprod(torch.flip(Gy, dims=(0,)), dim=0), dims=(0,))
    suf = torch.cat([rev[1:], ones], dim=0)
    return pre * suf


class ResidualTerms(NamedTuple):
    r_norm_sq: torch.Tensor     # full Lemma-3.4 squared residual
    r_comp_sq: torch.Tensor     # ‖Hy − b̃‖² (compressed part; may go negative)
    boundary_sq: torch.Tensor   # Σ_s h²‖y_𝔏‖² term
    cancel_scale: torch.Tensor  # ‖Hy‖² + ‖b̃‖²: the scale of r_comp_sq's cancellation error


def residual_norm_sq(H, Y, btil, k, weights, subdiag) -> ResidualTerms:
    """Full residual evaluation.

    Args:
      H: (d, K, K) projected factors (padded). Y: (d, K, T) CP factors.
      btil: (d, K), or a block (d, K, R). k: active column count. weights: (T,).
      subdiag: (d,) entries h^{(s)}_{k+1,k}, or the block-Krylov boundary
      blocks (d, R, R) = H_s[k:k+R, k-R:k] (block Lemma 3.4).
    """
    Hm, Ym, btil_m = _mask_yz(H, Y, btil, k)
    Z, Gy, Gz, X = cp_gram_matrices(Hm, Ym)

    hy2 = mv_norm_sq(Gy, Gz, X, weights)
    ip = tensor_inner_prod(Ym, Z, btil_m, weights)
    if btil_m.dim() == 2:
        b2 = torch.prod(torch.sum(btil_m * btil_m, dim=1))
    else:
        # ‖Σ_r ⊗_s b̃_{s,r}‖² = Σ_{r,q} Π_s ⟨b̃_{s,r}, b̃_{s,q}⟩
        b2 = torch.sum(torch.prod(torch.einsum("dkr,dkq->drq", btil_m, btil_m), dim=0))
    r_comp_sq = hy2 - 2.0 * ip + b2

    if subdiag.dim() == 1:
        # boundary terms: row k-1 of y in mode s across all ranks, weighted by h²
        yk = Y[:, k - 1]                                               # (d, T)
        bg = (subdiag * subdiag)[:, None, None] * yk[:, :, None] * yk[:, None, :]  # (d, T, T)
    else:
        # the trailing R rows of y in mode s, weighted by the boundary block's
        # Gram BᵀB (A_s V_s = V_s H_s + Q_s B_s E_Rᵀ, Q_s ⟂ V_s orthonormal)
        R = subdiag.shape[1]
        yrows = Y[:, k - R:k]                                          # (d, R, T)
        M = torch.einsum("dri,drj->dij", subdiag, subdiag)             # (d, R, R)
        bg = torch.einsum("drt,drq,dqu->dtu", yrows, M, yrows)         # (d, T, T)
    E = excluded_products(Gy)
    per_mode = torch.einsum("i,dij,j->d", weights, bg * E, weights)
    boundary = torch.sum(per_mode)

    return ResidualTerms(boundary + torch.clamp(r_comp_sq, min=0.0), r_comp_sq, boundary, hy2 + b2)
