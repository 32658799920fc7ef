"""Plain reference of the convection–diffusion deployment: the nonsymmetric
test problem of Kressner and Tobler (2010), −Δu + convection + σu on the
unit cube in d dimensions, Dirichlet boundary, n interior points a side.

Each factor is the reference implementation's ``assemble_matrix(n,
ConvDiff, c)`` shifted by σ:

  A_s = (n+1)²·tridiag(−1, 2, −1) + (c/4h)·diags(+1 @ −1, +3 @ 0, −5 @ +1, +1 @ +2) + σ I,

h = 1/(n+1), σ the shift that gives the shifted Laplacian the condition
number κ. There is no closed-form eigenbasis, so the reference solves by the
published algorithm, written plainly, in the dtype it is given:

* one Arnoldi recurrence a factor from b_s/‖b_s‖, each new vector
  orthogonalized by two modified Gram–Schmidt sweeps against every earlier
  one, the coefficients of both summed into the Hessenberg H_s (TensorKrylov.jl's
  ``orthonormalize!(·, MGS)``); the d recurrences run side by side as rows
  of (d, n) tensors, with no padding and no kernels of their own;
* the projected system H y = ‖b‖ e_1, H the Kronecker sum of the k×k
  Hessenbergs, solved in CP form by Stenger's sinc rule of 1/z on Re z ≥ 1,
  1/z ≈ Σ_j ω_j exp(−α_j z), h = π/√t, j = −t..t, α_j = asinh(e^{jh}),
  ω_j = h/√(1 + e^{−2jh}), scaled by λ_min = Σ_s min Re λ(H_s): each term
  exp(−(α_j/λ_min) H_s) e_1 through one dense complex eigendecomposition of
  H_s, H_s = S Λ S⁻¹;
* x = Σ_j (ω_j/λ_min) ⊗_s ‖b_s‖ V_s exp(−(α_j/λ_min) H_s) e_1.

Departures from the paper, each noted:

* k. The paper stops when its Lemma-3.4 estimate falls below tol. Here
  every CHECK steps the estimate's first part, Σ_s |h^{(s)}_{k+1,k}|²·
  ‖y ×_s e_kᵀ‖² from the Grams of y's factors, is read, and k is the first
  check at or below TARGET, or, once the estimate has stopped falling (a
  float32 solve stalls far above), the check that read lowest. The second
  part, ‖H y − b̃‖, is left to the sinc rule, whose error is set below
  TARGET; the Gram form of ‖H y − b̃‖² cancels near √eps·‖b‖.
* The sinc rule's half-width t. The paper takes the smallest t with
  2.75·exp(−π√(t/2)) ≤ tol·λ_min; here ≤ TARGET/κ_H, κ_H = Σ_s max |λ(H_s)| / λ_min,
  so that the rule's relative error on the spectrum costs at most TARGET.
* λ_min and κ_H come from the eigenvalues of the Hessenbergs (the paper
  reads λ_min from the leading minor of A_s).
* The exponentials go through the eigendecomposition, not a matrix
  exponential a term; the real part of the product is kept.

It imports nothing of the program or of the harness.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["sigma_for_kappa", "program_operator", "factor_bands", "bands", "stenger", "solve", "solve_config"]

OFFSETS = (-1, 0, 1, 2)
CHECK = 16          # steps between the reference's own checks
TARGET = 1e-9       # the estimate the reference stops at (a tenth of the benchmark's 1e-8)
KMAX = 512          # the most steps it takes


def sigma_for_kappa(n: int, kappa: float) -> float:
    """The shift σ that gives the 1-D Dirichlet Laplacian factor the
    condition number κ."""
    lmax = 4.0 * (n + 1) ** 2 * np.sin(n * np.pi / (2 * (n + 1))) ** 2
    lmin = 4.0 * (n + 1) ** 2 * np.sin(np.pi / (2 * (n + 1))) ** 2
    return float((lmax - kappa * lmin) / (kappa - 1.0))


def _shape(op_cfg: dict):
    n = int(op_cfg["n"])
    return int(op_cfg["d"]), n, float(op_cfg["c"]), sigma_for_kappa(n, float(op_cfg["kappa"]))


def program_operator(op_cfg: dict):
    """The program's gallery call for this configuration: its name and
    arguments (σ worked out here, from κ)."""
    d, n, c, sigma = _shape(op_cfg)
    return "conv_diff", dict(d=d, n=n, c=c, shift=sigma)


def factor_bands(op_cfg: dict, device):
    """(OFFSETS, bands (d, 4, n) f64 on device) of this configuration."""
    return OFFSETS, bands(*_shape(op_cfg), device=device)


def bands(d: int, n: int, c: float, sigma: float, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The factors as (d, 4, n) bands over OFFSETS, bands[s, b, i] =
    A_s[i, i + OFFSETS[b]], zero outside the matrix."""
    h2, cv = float((n + 1) ** 2), c * (n + 1) / 4.0
    out = torch.zeros((d, 4, n), dtype=dtype, device=device)
    out[:, 0, 1:] = -h2 + cv
    out[:, 1] = 2.0 * h2 + 3.0 * cv + sigma
    out[:, 2, :n - 1] = -h2 - 5.0 * cv
    out[:, 3, :n - 2] = cv
    return out


def stenger(eps: float):
    """(ω, α) of the sinc rule whose a-priori error 2.75·exp(−π√(t/2)) is at
    most eps: 2t + 1 terms."""
    t = max(1, math.ceil(2.0 * (math.log(2.75 / eps) / math.pi) ** 2))
    h = math.pi / math.sqrt(t)
    jh = np.arange(-t, t + 1) * h
    return h / np.sqrt(1.0 + np.exp(-2.0 * jh)), np.arcsinh(np.exp(jh))


def _spmv(B, v):
    """A_s v_s for every factor s: B (d, 4, n) bands over OFFSETS, v (d, n)."""
    n = v.shape[1]
    out = torch.zeros_like(v)
    for b, off in enumerate(OFFSETS):
        lo, hi = max(0, -off), min(n, n - off)
        out[:, lo:hi] += B[:, b, lo:hi] * v[:, lo + off:hi + off]
    return out


def _arnoldi_step(B, V, H, j: int) -> bool:
    """Extends V (d, ≥ j+2, n) by column j + 1 and writes column j of H
    (d, ≥ j+2, ≥ j+1); False where the new vector vanishes (the space is
    invariant) and nothing is written past column j."""
    w = _spmv(B, V[:, j])
    for _ in range(2):                    # two modified Gram–Schmidt sweeps
        for i in range(j + 1):
            hij = torch.sum(V[:, i] * w, dim=1)
            w = w - hij[:, None] * V[:, i]
            H[:, i, j] += hij
    nrm = torch.linalg.vector_norm(w, dim=1)
    if bool(torch.any(nrm <= 1e3 * torch.finfo(w.dtype).eps * torch.linalg.vector_norm(H[:, :j + 1, j], dim=1))):
        return False
    H[:, j + 1, j] = nrm
    V[:, j + 1] = w / nrm[:, None]
    return True


def _projected(H, b_norm, k: int):
    """(weights (t,), Y (d, k, t)) of the projected answer at k,
    y = Σ_j w_j ⊗_s Y[s, :, j] ≈ H⁻¹ (‖b_s‖ e_1)_s."""
    Hk = H[:, :k, :k]
    lam, S = torch.linalg.eig(Hk)                                   # (d, k), (d, k, k) complex
    lmin = float(torch.sum(torch.min(lam.real, dim=1).values))
    kappa = float(torch.sum(torch.max(lam.abs(), dim=1).values)) / lmin
    omega, alpha = stenger(TARGET / kappa)
    gamma = torch.as_tensor(alpha / lmin, dtype=lam.dtype, device=lam.device)
    e1 = torch.zeros((Hk.shape[0], k, 1), dtype=S.dtype, device=S.device)
    e1[:, 0, 0] = 1.0
    g = torch.linalg.solve(S, e1)[..., 0]                           # S⁻¹ e_1, (d, k)
    Y = torch.einsum("dki,di,dit->dkt", S, g, torch.exp(-lam[:, :, None] * gamma[None, None, :])).real
    return torch.as_tensor(omega / lmin, dtype=H.dtype, device=H.device), Y * b_norm[:, None, None]


def _estimate(H, w, Y, k: int):
    """Lemma 3.4's first part, (Σ_s |h^{(s)}_{k+1,k}|² ‖y ×_s e_kᵀ‖²)^{1/2},
    from the Grams of the factors."""
    d = Y.shape[0]
    G = torch.einsum("dki,dkj->dij", Y, Y)
    total = torch.zeros((), dtype=Y.dtype, device=Y.device)
    for s in range(d):
        a = w * Y[s, k - 1]
        others = torch.prod(G[torch.arange(d, device=G.device) != s], dim=0)
        total = total + H[s, k, k - 1] ** 2 * (a @ others @ a)
    return torch.sqrt(torch.clamp(total, min=0.0))


def solve(d: int, n: int, c: float, sigma: float, b: torch.Tensor, dtype=torch.float64):
    """x ≈ A⁻¹ b as (weights (t,), factors (d, n, t)) in dtype, on b's
    device, every operation in dtype (the benchmark's control runs it in
    float32)."""
    B, b = bands(d, n, c, sigma, dtype, b.device), b.to(dtype)
    kmax = min(KMAX, n)
    b_norm = torch.linalg.vector_norm(b, dim=1)
    V = torch.zeros((d, kmax + 1, n), dtype=dtype, device=b.device)
    H = torch.zeros((d, kmax + 1, kmax), dtype=dtype, device=b.device)
    V[:, 0] = b / b_norm[:, None]
    best, best_est, stalled = None, math.inf, 0
    for j in range(kmax):
        grown = _arnoldi_step(B, V, H, j)
        k = j + 1
        if k % CHECK and k < kmax and grown:
            continue
        w, Y = _projected(H, b_norm, k)
        est = float(_estimate(H, w, Y, k) / torch.prod(b_norm))
        # stalled: two checks in a row that did not halve the lowest estimate
        stalled = 0 if est < 0.5 * best_est else stalled + 1
        if est < best_est:
            best, best_est = (w, Y, k), est
        if best_est <= TARGET or stalled >= 2 or not grown:
            break
    w, Y, k = best
    return w, torch.einsum("dkn,dkt->dnt", V[:, :k], Y)


def solve_config(op_cfg: dict, b: torch.Tensor, dtype=torch.float64):
    """solve() for this configuration's operator."""
    return solve(*_shape(op_cfg), b, dtype)
