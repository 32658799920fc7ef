"""Exponential-sum solve of the projected system: counterpart of
``tensorkrylov_tpu/ops/expsum.py:cp_solve_sym`` (SPD path).

H y = b̃ with H = Σ_s ⊕ H_s is solved in rank-t CP form via
1/x ≈ Σ_j ω_j exp(−α_j x):  y = Σ_j (ω_j/λ_min) ⊗_s exp(−(α_j/λ_min) H_s) b̃_s.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["cp_solve_sym"]


def cp_solve_sym(w, Q, btil, k, omega, alpha, t_mask, lam_min) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (weights (tmax·R,), factors (d, K, tmax·R)) of the CP solution.

    w (d, K), Q (d, K, K): eigendecomposition of the padded H_s minors;
    btil (d, K) or a rank-R block (d, K, R); k the active size; omega, alpha,
    t_mask (tmax,) the masked exp-sum coefficients; lam_min the λ_min of the
    projected Kronecker sum.

    factors[s, :, j·R+r] = Q (exp(−w α_j/λ_min) ∘ (Qᵀ b̃)) — exact for the
    active block because the padding is decoupled and b̃ is zero there.
    """
    K = w.shape[1]
    if btil.dim() == 2:
        btil = btil[:, :, None]
    R = btil.shape[2]
    m = (torch.arange(K, device=w.device) < k).to(btil.dtype)
    g = torch.einsum("dkj,dkr->djr", Q, btil * m[None, :, None])      # Qᵀ b̃
    ex = torch.exp(-torch.clamp(w[:, :, None] * (alpha / lam_min)[None, None, :], -700.0, 700.0))
    factors = torch.einsum("dkj,djt,djr->dktr", Q, ex, g) * t_mask[None, None, :, None]
    weights = torch.repeat_interleave((omega / lam_min) * t_mask, R)
    return weights, factors.reshape(factors.shape[0], K, -1)
