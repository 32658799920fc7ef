"""Problem gallery: counterparts of ``tensorkrylov_tpu/models/gallery.py``.

Matrices are assembled on the host in numpy float64 and moved to the
requested device once.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..types import KroneckerSumOperator

__all__ = [
    "laplace",
    "reaction_diffusion",
    "rand_spd",
    "dense_to_bands",
    "bands_to_dense",
    "operator_from_dense_factors",
]


def _to_operator(bands: np.ndarray, offsets, symmetric: bool, dtype, device) -> KroneckerSumOperator:
    return KroneckerSumOperator(
        torch.as_tensor(np.ascontiguousarray(bands), dtype=dtype, device=device),
        tuple(int(o) for o in offsets),
        symmetric,
    )


def _banded_operator(diags: dict, d: int, n: int, dtype, symmetric: bool, device) -> KroneckerSumOperator:
    """Operator whose d factors all equal the banded matrix {offset: value}."""
    offsets = tuple(sorted(diags.keys()))
    bands = np.zeros((len(offsets), n), dtype=np.float64)
    for b, off in enumerate(offsets):
        length = n - abs(off)
        vals = np.broadcast_to(np.asarray(diags[off], dtype=np.float64), (length,))
        if off >= 0:
            bands[b, :length] = vals
        else:
            bands[b, -off:] = vals
    stacked = np.broadcast_to(bands, (d, len(offsets), n))
    return _to_operator(stacked, offsets, symmetric, dtype, device)


def laplace(d: int, n: int, dtype=torch.float64, shift: float = 0.0, device="cpu") -> KroneckerSumOperator:
    """1-D Dirichlet Laplacian factors (1/h²)·tridiag(-1, 2, -1), h = 1/(n+1),
    plus an optional diagonal shift σ·I per factor."""
    h2inv = float((n + 1) ** 2)
    return _banded_operator(
        {-1: -h2inv, 0: 2.0 * h2inv + float(shift), 1: -h2inv}, d, n, dtype, True, device
    )


def reaction_diffusion(d: int, n: int, sigma: float, dtype=torch.float64, device="cpu") -> KroneckerSumOperator:
    """σu − Δu factors: the Laplacian shifted by σ (one implicit-Euler step of
    a d-dimensional reaction–diffusion equation, κ ≈ (σ + 4(n+1)²)/(σ + π²))."""
    return laplace(d, n, dtype=dtype, shift=float(sigma), device=device)


def rand_spd(d: int, n: int, seed: int = 0, dtype=torch.float64, device="cpu") -> KroneckerSumOperator:
    """Random dense SPD factors A_s = R_sᵀ R_s, distinct per factor, drawn
    with numpy exactly as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(d):
        r = rng.random((n, n))
        mats.append(r.T @ r)
    return operator_from_dense_factors(np.stack(mats), symmetric=True, dtype=dtype, device=device)


def dense_to_bands(mats: np.ndarray, offsets: Optional[Sequence[int]] = None):
    """(d, n, n) dense factors → ((d, nb, n) bands, offsets tuple).

    If offsets is None, detects nonzero diagonals across all factors.
    """
    mats = np.asarray(mats)
    d, n, _ = mats.shape
    if offsets is None:
        offsets = [
            off
            for off in range(-(n - 1), n)
            if any(np.any(np.diagonal(mats[s], off)) for s in range(d))
        ]
        if not offsets:
            offsets = [0]
    offsets = tuple(offsets)
    bands = np.zeros((d, len(offsets), n), dtype=mats.dtype)
    for b, off in enumerate(offsets):
        length = n - abs(off)
        for s in range(d):
            diag = np.diagonal(mats[s], off)
            if off >= 0:
                bands[s, b, :length] = diag
            else:
                bands[s, b, -off:] = diag
    return bands, offsets


def bands_to_dense(op: KroneckerSumOperator) -> np.ndarray:
    """(d, nb, n) bands → (d, n, n) dense numpy factors (test/debug oracle)."""
    bands = op.bands.detach().cpu().numpy()
    d, nb, n = bands.shape
    out = np.zeros((d, n, n), dtype=bands.dtype)
    i = np.arange(n)
    for b, off in enumerate(op.offsets):
        j = i + off
        ok = (j >= 0) & (j < n)
        out[:, i[ok], j[ok]] = bands[:, b, i[ok]]
    return out


def operator_from_dense_factors(mats, symmetric: bool, dtype=torch.float64, device="cpu") -> KroneckerSumOperator:
    if isinstance(mats, (list, tuple)):
        shapes = {np.asarray(A).shape for A in mats}
        if len(shapes) > 1:
            raise ValueError(f"factors have different sizes {sorted(shapes)}")
        mats = np.stack([np.asarray(A, np.float64) for A in mats])
    bands, offsets = dense_to_bands(np.asarray(mats, dtype=np.float64))
    return _to_operator(bands, offsets, symmetric, dtype, device)
