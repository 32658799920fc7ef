"""Exponential-sum rank and coefficient selection: counterpart of
``tensorkrylov_tpu/coeffs/tables.py``.

The Braess–Hackbusch tables are the port's own packed file,
``coeffs/data/bh_tables.npz`` beside this module, read with numpy; it holds
the same arrays as the JAX package's file, and ``coeffs/preprocess.py``
repacks it from the reference's raw files. Selection is tensor code on the
tables' device; the tables are indexed by Python ints, so it reads the
row's digit and order, the row and the rank into Python (four reads through
``utils/profiling.host_read``, each a wait for the device).
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import host_read

TMAX = 63
DEFAULT_NPZ = Path(__file__).resolve().parent / "data" / "bh_tables.npz"

__all__ = ["BHTables", "ExpSumCoeffs", "load_tables", "select_bh", "stenger_eps", "select_stenger", "TMAX"]


class BHTables(NamedTuple):
    R_values: torch.Tensor  # (nR,)
    err: torch.Tensor       # (nR, TMAX)
    omega: torch.Tensor     # (nR, TMAX, TMAX)
    alpha: torch.Tensor     # (nR, TMAX, TMAX)
    grid: torch.Tensor      # (10, n_orders) int64 row index


def load_tables(path=DEFAULT_NPZ, dtype=torch.float64, device="cpu") -> BHTables:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return BHTables(
        R_values=torch.tensor(arrays["R_values"], dtype=dtype, device=device),
        err=torch.tensor(arrays["err"], dtype=dtype, device=device),
        omega=torch.tensor(arrays["omega"], dtype=dtype, device=device),
        alpha=torch.tensor(arrays["alpha"], dtype=dtype, device=device),
        grid=torch.tensor(arrays["grid"], dtype=torch.int64, device=device),
    )


class ExpSumCoeffs(NamedTuple):
    omega: torch.Tensor   # (tmax,) masked
    alpha: torch.Tensor   # (tmax,) masked
    t_mask: torch.Tensor  # (tmax,) 1.0 on active terms
    rank: torch.Tensor    # int32 number of active terms
    err: torch.Tensor     # tabulated/bounded uniform error of the sum


def select_bh(kappa: torch.Tensor, tol, tables: BHTables, tmax: int = TMAX, row_select: str = "ceil") -> ExpSumCoeffs:
    """κ → (first digit, order) → table row, then the smallest rank whose
    tabulated error ≤ tol, or the most accurate available rank when none
    meets tol (the returned `err` shows the shortfall).

    row_select='ceil' picks the smallest tabulated R ≥ κ; 'reference'
    floors κ to its first significant digit, as the JAX package documents.
    """
    dtype = tables.err.dtype
    dev = tables.err.device
    kappa = torch.clamp(torch.as_tensor(kappa, dtype=dtype, device=dev), min=2.0)  # table starts at R=2
    order = torch.floor(torch.log10(kappa)).to(torch.int64)
    scaled = kappa / (10.0 ** order.to(dtype))
    if row_select == "ceil":
        digit = torch.ceil(scaled).to(torch.int64)
        order = torch.where(digit > 9, order + 1, order)  # ceil(9.3) → R = 1e(o+1)
        digit = torch.where(digit > 9, torch.ones_like(digit), digit)
    else:
        digit = torch.floor(scaled).to(torch.int64)
    n_orders = tables.grid.shape[1]
    order = torch.clamp(order, 0, n_orders - 1)
    digit = torch.clamp(digit, 1, 9)
    row = host_read(tables.grid[host_read(digit, int), host_read(order, int)], int)

    errs = tables.err[row]                                  # (TMAX,)
    avail = torch.arange(TMAX, device=dev) < min(tmax, TMAX)
    ok = (errs <= tol) & avail
    first_ok = torch.argmax(ok.to(torch.int8))             # first index meeting tol
    best = torch.argmin(torch.where(torch.isfinite(errs) & avail, errs, math.inf))
    t_idx = torch.where(ok.any(), first_ok, best)
    t = host_read(t_idx, int)

    omega = tables.omega[row, t]
    alpha = tables.alpha[row, t]
    if tmax > TMAX:
        omega = torch.nn.functional.pad(omega, (0, tmax - TMAX))
        alpha = torch.nn.functional.pad(alpha, (0, tmax - TMAX))
    elif tmax < TMAX:
        omega = omega[:tmax]
        alpha = alpha[:tmax]
    rank = (t_idx + 1).to(torch.int32)
    t_mask = (torch.arange(tmax, device=dev) < rank).to(dtype)
    return ExpSumCoeffs(omega, alpha, t_mask, rank, errs[t])


def stenger_eps(rank, dtype=torch.float64):
    """Uniform-error model 2.75 · exp(−π√(t/2)) of the 2t+1-term sinc rule
    for 1/x on [1, ∞)."""
    rank = torch.as_tensor(rank).to(dtype)
    return 2.75 * torch.exp(-math.pi * torch.sqrt(rank / 2.0))


def select_stenger(eps_target, tmax: int = TMAX, dtype=torch.float64, device=None) -> ExpSumCoeffs:
    """Closed-form sinc-rule coefficients: with h = π/√t and j = −t..t,
    α_j = asinh(e^{jh}) and ω_j = h/√(1+e^{−2jh}), laid out in slots 0..2t
    of the (tmax,) grid. t is the smallest half-width with
    stenger_eps(t) ≤ eps_target, clamped to (tmax−1)//2."""
    eps_target = torch.as_tensor(eps_target, dtype=dtype, device=device)
    arg = torch.log(2.75 / torch.clamp(eps_target, min=1e-300)) / math.pi
    t = torch.ceil(2.0 * torch.clamp(arg, min=0.0) ** 2).to(torch.int32)
    t = torch.clamp(t, min=1)
    t = torch.where(stenger_eps(t - 1, dtype) <= eps_target, torch.clamp(t - 1, min=1), t)
    t = torch.clamp(t, max=(tmax - 1) // 2)

    h = math.pi / torch.sqrt(t.to(dtype))
    slots = torch.arange(tmax, device=eps_target.device)
    j = (slots - t).to(dtype)
    n_terms = 2 * t + 1
    mask = (slots < n_terms).to(dtype)
    jh = torch.clamp(j * h * mask, -700.0, 700.0)
    alpha = torch.asinh(torch.exp(jh)) * mask
    omega = h / torch.sqrt(1.0 + torch.exp(torch.clamp(-2.0 * jh, -700.0, 700.0))) * mask
    return ExpSumCoeffs(omega, alpha, mask, n_terms.to(torch.int32), stenger_eps(t, dtype))
