"""Exponential-sum solve of the projected system: counterpart of
``tensorkrylov_tpu/ops/expsum.py``.

H y = b̃ with H = Σ_s ⊕ H_s is solved in rank-t CP form via
1/x ≈ Σ_j ω_j exp(−α_j x):  y = Σ_j (ω_j/λ_min) ⊗_s exp(−(α_j/λ_min) H_s) b̃_s.

The nonsymmetric solves use native f64 LAPACK-style routines
(``torch.linalg.eig``, ``solve`` and ``matrix_exp``), which run on the CPU and
on CUDA; the JAX package's LU-free Taylor ``expm_taylor_ss`` exists only
because the TPU has no f64 LU and is not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.profiling import host_read

__all__ = ["cp_solve_sym", "cp_solve_nonsym", "cp_solve_nonsym_eig"]


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


def _masked(H, btil, k):
    """The active k×k blocks of H (d, K, K), b̃ as (d, K, R) zeroed beyond k,
    and the (K,) mask."""
    K = H.shape[1]
    if btil.dim() == 2:
        btil = btil[:, :, None]
    m = (torch.arange(K, device=H.device) < k).to(H.dtype)
    return H * m[None, :, None] * m[None, None, :], btil * m[None, :, None], m


def cp_solve_nonsym_eig(H, btil, k, omega, alpha, t_mask, lam_min) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonsymmetric projected solve through one complex eigendecomposition
    per factor: y_j = S exp(−γ_j Λ) S⁻¹ b̃ for all t terms at once, with
    γ_j = α_j/λ_min. It rests on the Arnoldi Hessenberg being non-defective
    (generic for the convection–diffusion family).

    H (d, K, K) Hessenberg factors (padded); btil (d, K) or (d, K, R); k the
    active size. Returns (weights (tmax·R,), factors (d, K, tmax·R)).
    """
    d, K, _ = H.shape
    tmax = alpha.shape[0]
    Hm, btil_m, m = _masked(H, btil, k)
    R = btil_m.shape[2]
    # decoupled positive padding (the corner Rayleigh value, as in
    # masked_eigh) keeps the padded eigenvalues simple; b̃ is zero there
    Hm = Hm + torch.diag_embed((1.0 - m)[None, :] * H[:, 0, 0][:, None])
    w, S = torch.linalg.eig(Hm)                               # complex (d, K), (d, K, K)
    g = torch.linalg.solve(S, btil_m.to(S.dtype))             # S⁻¹ b̃: (d, K, R)
    expw = torch.exp(-w[:, :, None] * (alpha / lam_min).to(S.dtype)[None, None, :])  # (d, K, tmax)
    # Σ_j S[k, j]·expw[j, t]·g[j, r] as one pairwise contraction over j
    factors = torch.einsum("dkjr,djt->dktr", S[:, :, :, None] * g[:, None, :, :], expw).real.to(H.dtype)
    factors = factors * t_mask[None, None, :, None] * m[None, :, None, None]
    weights = torch.repeat_interleave((omega / lam_min) * t_mask, R)
    return weights, factors.reshape(d, K, tmax * R)


def cp_solve_nonsym(H, btil, k, omega, alpha, t_mask, lam_min) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonsymmetric projected solve term by term: column j of the factors is
    exp(−γ_j H_s) b̃_s, with torch.linalg.matrix_exp in the input's dtype.
    Only the active terms pay their matrix exponential (one host read of the
    rank). Same arguments and returns as cp_solve_nonsym_eig."""
    d, K, _ = H.shape
    tmax = alpha.shape[0]
    Hm, btil_m, _ = _masked(H, btil, k)
    R = btil_m.shape[2]
    factors = torch.zeros((d, K, tmax, R), dtype=H.dtype, device=H.device)
    for j in range(host_read(torch.sum(t_mask), int)):
        factors[:, :, j] = torch.linalg.matrix_exp(Hm * (-alpha[j] / lam_min)) @ btil_m
    factors = factors * t_mask[None, None, :, None]
    weights = torch.repeat_interleave((omega / lam_min) * t_mask, R)
    return weights, factors.reshape(d, K, tmax * R)
