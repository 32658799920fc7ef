"""Spectral estimation for the projected Kronecker-sum operator: counterpart
of ``tensorkrylov_tpu/ops/eigen.py`` (the dense-eigh path; the mixed-precision
tridiagonal solver is not ported, since native f64 ``torch.linalg.eigh``
replaces it on the card)."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..types import KroneckerSumOperator

__all__ = [
    "dense_minor_window",
    "masked_eigh",
    "sym_extremes_from_eigs",
    "analytic_laplace_extremes",
    "laplace_eigenvector",
    "laplace_eigenspace",
    "bendixson_lambda_min",
    "tridiag_eigvalsh_sturm",
]


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


def laplace_eigenvector(n: int, j: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Unit-norm eigenvector j (1-based) of the n×n Dirichlet Laplacian:
    v_j(i) ∝ sin(i·j·π/(n+1))."""
    i = torch.arange(1, n + 1, dtype=dtype, device=device)
    v = torch.sin(i * j * math.pi / (n + 1))
    return v / torch.linalg.vector_norm(v)


def laplace_eigenspace(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """(n, n) matrix whose columns are the unit-norm Laplacian eigenvectors."""
    i = torch.arange(1, n + 1, dtype=dtype, device=device)
    V = torch.sin(torch.outer(i, i) * math.pi / (n + 1))
    return V / torch.linalg.vector_norm(V, dim=0, keepdim=True)


def bendixson_lambda_min(W: torch.Tensor, k) -> torch.Tensor:
    """Lower bound on min Re λ of the active k×k minors of W (d, K, K) from
    their symmetric parts (Bendixson): Σ_s λ_min(sym(W_s minor)), which is
    ≤ the true minimum real part of the Kronecker sum."""
    w, _ = masked_eigh(W, k)
    return torch.sum(w.min(dim=1).values)


def _sturm_count(diag: torch.Tensor, off2: torch.Tensor, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Number of eigenvalues < x of the masked symmetric tridiagonal(s).

    diag, off2 (squared off-diagonals, off2[..., 0] = 0) and mask: (..., K);
    x: (...). The LAPACK dstebz recurrence q_i = (d_i − x) − e²_{i−1}/q_{i−1},
    counting negative q_i, with |q| < tiny·1e8 set to −tiny·1e8. Masked rows
    hold q = 1: no count, no coupling.
    """
    eps = torch.finfo(diag.dtype).tiny * 1e8
    q = torch.ones_like(x)
    count = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i in range(diag.shape[-1]):
        active = mask[..., i] > 0
        q = (diag[..., i] - x) - off2[..., i] / q
        q = torch.where(q.abs() < eps, torch.full_like(q, -eps), q)
        q = torch.where(active, q, torch.ones_like(q))
        count = count + ((q < 0) & active).to(torch.int32)
    return count


def tridiag_eigvalsh_sturm(diag: torch.Tensor, offdiag: torch.Tensor, k=None, n_iter: int = 80) -> torch.Tensor:
    """All eigenvalues of batched symmetric tridiagonals by bisection.

    diag: (d, K); offdiag: (d, K) with offdiag[:, 0] unused (e_i couples rows
    i−1 and i). With k, only the leading k×k minor is active, and the inactive
    slots return the upper Gershgorin bound. Branch-free: every eigenvalue
    index of every factor bisects at once from the Gershgorin interval, for
    n_iter halvings. Returns (d, K), eigenvalue j in slot j (ascending on the
    active block).
    """
    d, K = diag.shape
    if k is None:
        k = K
    mask = (torch.arange(K, device=diag.device)[None, :] < k).to(diag.dtype)
    e = torch.cat([torch.zeros((d, 1), dtype=diag.dtype, device=diag.device), offdiag[:, 1:]], dim=1)
    e = e * mask * torch.roll(mask, 1, dims=1)  # decouple masked rows
    e2 = e * e

    # Gershgorin bounds over the active rows
    radius = e.abs() + torch.roll(e, -1, dims=1).abs() * torch.roll(mask, -1, dims=1)
    inf = torch.tensor(float("inf"), dtype=diag.dtype, device=diag.device)
    lo = torch.where(mask > 0, diag - radius, inf).min(dim=1, keepdim=True).values.expand(d, K)
    hi = torch.where(mask > 0, diag + radius, -inf).max(dim=1, keepdim=True).values.expand(d, K)

    # eigenvalue index j: bisect towards the x with count(x) <= j < count(hi)
    targets = torch.arange(K, device=diag.device)[None, :]
    diag_b = diag[:, None, :].expand(d, K, K)
    e2_b = e2[:, None, :].expand(d, K, K)
    mask_b = mask[:, None, :].expand(d, K, K)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        go_right = _sturm_count(diag_b, e2_b, mid, mask_b) <= targets
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)
