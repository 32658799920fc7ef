"""The true relative residual ‖A x − b‖ / ‖b‖ of a CP solution, in plain torch.

A = Σ_s I⊗…⊗A_s⊗…⊗I is a Kronecker sum of banded factors, x = Σ_j w_j ⊗_s
X[s, :, j] a CP tensor and b = ⊗_s b[s] a rank-1 tensor. Nothing here comes
from the program under test: the factors are the caller's own bands, and x
is only read.

Why not the Gram of the CP terms: ‖A x − b‖² from inner products is a
difference of O(‖b‖²) quantities, so in f64 it floors near √eps ≈ 1e-8 of
‖b‖, which is the tolerance the benchmark has to check. Here r = A x − b is
written as a tensor train of ranks 2t + 1 (the path "A not yet applied",
"A applied once", and b), each mode's columns [X_s, A_s X_s, b_s] are
replaced by their coordinates in an orthonormal basis (a QR), and the train
is orthogonalized from the left, one QR a mode. Orthogonal transforms keep
the norm, and each QR is backward stable, so the error of ‖r‖ is of order
eps·(‖A x‖ + ‖b‖) rather than √(eps)·‖b‖.
"""
from __future__ import annotations

import math

import torch

__all__ = ["apply_factors", "relative_residual"]


def apply_factors(offsets, bands: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Y[s] = A_s X[s] for X (d, n, t) and bands (d, nb, n), where
    bands[s, b, i] = A_s[i, i + offsets[b]] inside the matrix."""
    d, nb, n = bands.shape
    Y = torch.zeros_like(X)
    for b, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            Y[:, lo:hi] += bands[:, b, lo:hi, None] * X[:, lo + off:hi + off]
    return Y


def _coordinates(offsets, bands_s: torch.Tensor, X_s: torch.Tensor, b_s: torch.Tensor):
    """(C_X, C_AX, c_b): the coordinates of X_s, A_s X_s and b_s in an
    orthonormal basis of their span (the R factor of one reduced QR)."""
    t = X_s.shape[1]
    AX = apply_factors(offsets, bands_s[None], X_s[None])[0]
    R = torch.linalg.qr(torch.cat([X_s, AX, b_s[:, None]], dim=1), mode="r").R
    return R[:, :t], R[:, t:2 * t], R[:, 2 * t]


def relative_residual(offsets, bands: torch.Tensor, weights: torch.Tensor, X: torch.Tensor,
                      b: torch.Tensor) -> float:
    """‖A x − b‖ / ‖b‖ in f64 on the tensors' device, one mode at a time.

    bands (d, nb, n), weights (t,), X (d, n, t), b (d, n)."""
    f64 = torch.float64
    bands, weights, X, b = (a.to(f64) for a in (bands, weights, X, b))
    d, n, t = X.shape
    if bands.shape[0] != d or b.shape != (d, n) or weights.shape != (t,):
        raise ValueError(f"shapes disagree: bands {tuple(bands.shape)}, weights {tuple(weights.shape)}, "
                         f"X {tuple(X.shape)}, b {tuple(b.shape)}")
    b_norm = math.prod(float(torch.linalg.vector_norm(b[s])) for s in range(d))
    CX, CAX, cb = _coordinates(offsets, bands[0], X[0], b[0])
    if d == 1:
        return float(torch.linalg.vector_norm(CAX @ weights - cb)) / b_norm
    # the first core, (m_1, 2t+1): [w·X_1 | w·A_1X_1 | −b_1] in coordinates
    P = torch.linalg.qr(torch.cat([CX * weights, CAX * weights, -cb[:, None]], dim=1), mode="r").R
    for s in range(1, d):
        CX, CAX, cb = _coordinates(offsets, bands[s], X[s], b[s])
        P0, P1, Pb = P[:, :t], P[:, t:2 * t], P[:, 2 * t]
        if s == d - 1:
            last = P0 @ CAX.T + P1 @ CX.T + Pb[:, None] * cb[None, :]
            return float(torch.linalg.vector_norm(last)) / b_norm
        # (ρ, m_s, 2t+1): block 0 keeps "not applied", block 1 is "applied
        # once" (entered here through A_s or carried through X_s), b apart
        core = torch.cat([P0[:, None, :] * CX[None],
                          P0[:, None, :] * CAX[None] + P1[:, None, :] * CX[None],
                          Pb[:, None, None] * cb[None, :, None]], dim=2)
        P = torch.linalg.qr(core.reshape(-1, 2 * t + 1), mode="r").R
    raise AssertionError("unreachable")
