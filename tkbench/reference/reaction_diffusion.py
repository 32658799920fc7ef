"""Plain reference of the reaction–diffusion deployment: σu − Δu on the unit
cube in d dimensions, Dirichlet boundary, n interior points a side.

Each factor is A_s = (n+1)²·tridiag(−1, 2, −1) + σ I, whose eigenvectors are
the sine modes (a DST-I) and eigenvalues λ_k = σ + 4(n+1)² sin²(kπ/(2(n+1))).
The reference solves A x = b without Krylov spaces or tables: A⁻¹ is
approximated by a sinc quadrature of 1/λ = ∫ exp(u − λ eᵘ) du, and each
term exp(−τ A) = ⊗_s exp(−τ A_s) is applied exactly in the sine basis. The
result is a CP tensor in the same layout as the program's. It imports
nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["sigma_for_kappa", "program_operator", "factor_bands", "bands", "eigenvalues", "dst", "sinc_coefficients",
           "solve", "solve_config"]

OFFSETS = (-1, 0, 1)


def sigma_for_kappa(n: int, kappa: float) -> float:
    """The shift σ that gives one factor the condition number κ."""
    lmax = 4.0 * (n + 1) ** 2 * np.sin(n * np.pi / (2 * (n + 1))) ** 2
    lmin = 4.0 * (n + 1) ** 2 * np.sin(np.pi / (2 * (n + 1))) ** 2
    return float((lmax - kappa * lmin) / (kappa - 1.0))


def program_operator(op_cfg: dict):
    """The program's gallery call for this configuration: its name and
    arguments (σ worked out here, from κ)."""
    n = int(op_cfg["n"])
    return "reaction_diffusion", dict(d=int(op_cfg["d"]), n=n, sigma=sigma_for_kappa(n, float(op_cfg["kappa"])))


def factor_bands(op_cfg: dict, device):
    """(OFFSETS, bands (d, 3, n) f64 on device) of this configuration."""
    n = int(op_cfg["n"])
    return OFFSETS, bands(int(op_cfg["d"]), n, sigma_for_kappa(n, float(op_cfg["kappa"])), device=device)


def bands(d: int, n: int, sigma: float, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The factors as (d, 3, n) bands over OFFSETS, zero outside the matrix."""
    h2 = float((n + 1) ** 2)
    out = torch.empty((d, 3, n), dtype=dtype, device=device)
    out[:, 0], out[:, 1], out[:, 2] = -h2, 2.0 * h2 + sigma, -h2
    out[:, 0, 0] = 0.0
    out[:, 2, -1] = 0.0
    return out


def eigenvalues(n: int, sigma: float, dtype=torch.float64, device="cpu") -> torch.Tensor:
    k = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    lam = sigma + 4.0 * (n + 1) ** 2 * torch.sin(k * math.pi / (2 * (n + 1))) ** 2
    return lam.to(dtype)


def dst(x: torch.Tensor) -> torch.Tensor:
    """The orthonormal DST-I along the last axis (its own inverse), by one FFT
    of length 2(n+1)."""
    n = x.shape[-1]
    z = torch.zeros(x.shape[:-1] + (2 * n + 2,), dtype=x.dtype, device=x.device)
    z[..., 1:n + 1] = x
    z[..., n + 2:] = -torch.flip(x, dims=[-1])
    return -torch.fft.fft(z)[..., 1:n + 1].imag * math.sqrt(0.5 / (n + 1))


def sinc_coefficients(lmin: float, lmax: float, eps: float = 1e-12):
    """(c, τ) with 1/λ ≈ Σ_j c_j exp(−τ_j λ) to relative eps on [lmin, lmax]:
    the trapezoid rule on 1/λ = ∫ exp(u − λ eᵘ) du, cut where either tail
    falls below eps (step h = π²/ln(2/eps), the strip of analyticity being
    |Im u| < π/2)."""
    kappa = lmax / lmin
    h = math.pi ** 2 / math.log(2.0 / eps)
    u_lo, u_hi = math.log(eps / kappa), math.log(math.log(1.0 / eps))
    u = np.arange(math.floor(u_lo / h), math.ceil(u_hi / h) + 1) * h
    return h * np.exp(u) / lmin, np.exp(u) / lmin


def solve(d: int, n: int, sigma: float, b: torch.Tensor, dtype=torch.float64, eps: float = 1e-12):
    """x ≈ A⁻¹ b as (weights (t,), factors (d, n, t)) in dtype, on b's device.
    Every operation runs in dtype: the benchmark's control runs it in float32."""
    lam = eigenvalues(n, sigma, dtype, b.device)
    lmin, lmax = d * float(lam[0]), d * float(lam[-1])
    c, tau = sinc_coefficients(lmin, lmax, eps)
    c = torch.as_tensor(c, dtype=dtype, device=b.device)
    tau = torch.as_tensor(tau, dtype=dtype, device=b.device)
    bh = dst(b.to(dtype))                                   # (d, n)
    X = torch.empty((d, n, tau.shape[0]), dtype=dtype, device=b.device)
    for s in range(d):
        decay = torch.exp(-tau[:, None] * lam[None, :])     # (t, n)
        X[s] = dst(decay * bh[s][None, :]).T
    return c, X


def solve_config(op_cfg: dict, b: torch.Tensor, dtype=torch.float64):
    """solve() for this configuration's operator."""
    n = int(op_cfg["n"])
    return solve(int(op_cfg["d"]), n, sigma_for_kappa(n, float(op_cfg["kappa"])), b, dtype)
