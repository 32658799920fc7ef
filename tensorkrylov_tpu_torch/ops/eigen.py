"""Spectral estimation for the projected Kronecker-sum operator: counterpart
of ``tensorkrylov_tpu/ops/eigen.py`` (the dense-eigh path; the mixed-precision
tridiagonal solver is not ported, since native f64 ``torch.linalg.eigh``
replaces it on the card)."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..types import KroneckerSumOperator

__all__ = ["dense_minor_window", "masked_eigh", "sym_extremes_from_eigs", "analytic_laplace_extremes"]


def dense_minor_window(op: KroneckerSumOperator, K: int) -> torch.Tensor:
    """Top-left K×K dense window of each factor: (d, K, K)."""
    d, nb, n = op.bands.shape
    Kc = min(K, n)
    W = torch.zeros((d, K, K), dtype=op.bands.dtype, device=op.device)
    for b, off in enumerate(op.offsets):
        if abs(off) >= Kc:
            continue
        length = Kc - abs(off)
        idx = torch.arange(length, device=op.device)
        if off >= 0:
            W[:, idx, idx + off] += op.bands[:, b, :length]
        else:
            W[:, idx - off, idx] += op.bands[:, b, -off:-off + length]
    return W


def masked_eigh(W: torch.Tensor, k) -> Tuple[torch.Tensor, torch.Tensor]:
    """eigh of the active k×k block of each (K, K) matrix in W (d, K, K).

    Padding trick: zero the coupling outside the block and put W[s,0,0] on
    the padded diagonal. W[0,0] is the k=1 Rayleigh value, which interlacing
    places inside [λ_min, λ_max] of every leading minor, so min/max over the
    padded spectrum equal the block's extremes, and matrix functions of the
    padded matrix applied to block-supported vectors are exact.

    Returns (w (d, K), Q (d, K, K)), ascending.
    """
    K = W.shape[1]
    m = (torch.arange(K, device=W.device) < k).to(W.dtype)
    Wm = W * m[None, :, None] * m[None, None, :]
    Wm = 0.5 * (Wm + Wm.transpose(1, 2))
    Wm = Wm + torch.diag_embed((1.0 - m)[None, :] * W[:, 0, 0][:, None])
    return torch.linalg.eigh(Wm)


def sym_extremes_from_eigs(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kronecker-sum extremes from per-factor spectra: λ_min = Σ_s min_s, etc."""
    return torch.sum(w.min(dim=1).values), torch.sum(w.max(dim=1).values)


def analytic_laplace_extremes(d: int, n: int, k, dtype=torch.float64, device=None):
    """Closed-form extremes of the Kronecker sum of k×k Laplacian minors:
    λ_j = (4/h²)·sin²(jπ/(2(k+1))), summed over d identical factors."""
    h2inv = torch.tensor(float((n + 1) ** 2), dtype=dtype, device=device)
    kf = torch.as_tensor(k, device=device).to(dtype)
    arg = math.pi / (2.0 * (kf + 1.0))
    return d * 4.0 * h2inv * torch.sin(arg) ** 2, d * 4.0 * h2inv * torch.sin(kf * arg) ** 2
