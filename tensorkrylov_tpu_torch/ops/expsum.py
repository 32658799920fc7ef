"""Exponential-sum solve of the projected system: counterpart of
``tensorkrylov_tpu/ops/expsum.py``.

H y = b̃ with H = Σ_s ⊕ H_s is solved in rank-t CP form via
1/x ≈ Σ_j ω_j exp(−α_j x):  y = Σ_j (ω_j/λ_min) ⊗_s exp(−(α_j/λ_min) H_s) b̃_s.

The nonsymmetric solves use native f64 LAPACK-style routines
(``torch.linalg.eig``, ``solve`` and ``matrix_exp``), which run on the CPU and
on CUDA; the JAX package's LU-free Taylor ``expm_taylor_ss`` exists only
because the TPU has no f64 LU and is not ported.

``expsum_sup_error_dd`` is the certificate's sup_{x ∈ [1, κ]} |1 − x·g(x)|,
g(x) = Σ_j ω_j e^{−α_j x}, on ``deflate.expsum_sup_error``'s log-spaced grid,
in double-double (df64) arithmetic: the CUDA kernel ``csrc/expsum_sup.cu`` on
a CUDA device, its plain version (the same operations on f64 tensors, built
on ``expansion.two_sum``/``two_prod``) on the CPU.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import host_read
from . import _build
from .expansion import _fast_two_sum, two_prod, two_sum

__all__ = ["cp_solve_sym", "cp_solve_nonsym", "cp_solve_nonsym_eig", "expsum_sup_error_dd", "exp_dd",
           "expsum_sup_ops"]


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
    (generic for the convection–diffusion family). The eigendecomposition
    counts as one host read (utils/profiling.host_read).

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
    # on a CUDA tensor eig waits for the card (its LAPACK-style routine works
    # on the host): a host read
    w, S = host_read(Hm, torch.linalg.eig)                    # complex (d, K), (d, K, K)
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


# The exp-sum sup error in df64. The constants are the kernel's
# (csrc/expsum_sup.cu), written alike in both files.
N_GRID = 200_000            # deflate.expsum_sup_error's grid
MAX_TERMS = 63              # the kernel's by-value terms: the coefficient tables' TMAX
ARG_MIN = -745.0            # e^a rounds to 0 in f64 below this: such terms are skipped
LOG_KAPPA_MAX = 690.0       # |log κ| ≤ 690 keeps every grid point's exp in range
_HALVINGS = 9               # r = (a − m ln2) / 2^9
_LN2 = (float.fromhex("0x1.62e42fefa39efp-1"), float.fromhex("0x1.abc9e3b39803fp-56"))
_INV_LN2 = float.fromhex("0x1.71547652b82fep+0")
_INV_FACT = tuple((float.fromhex(h), float.fromhex(lo)) for h, lo in (        # 1/3! .. 1/8!
    ("0x1.5555555555555p-3", "0x1.5555555555555p-57"), ("0x1.5555555555555p-5", "0x1.5555555555555p-59"),
    ("0x1.1111111111111p-7", "0x1.1111111111111p-63"), ("0x1.6c16c16c16c17p-10", "-0x1.f49f49f49f49fp-65"),
    ("0x1.a01a01a01a01ap-13", "0x1.a01a01a01a01ap-73"), ("0x1.a01a01a01a01ap-16", "0x1.a01a01a01a01ap-76")))
_CHUNK = 1 << 20            # (term, point) pairs per step of the plain version


def _dd_add(ah, al, bh, bl):
    sh, sl = two_sum(ah, bh)
    th, tl = two_sum(al, bl)
    sh, sl = _fast_two_sum(sh, sl + th)
    return _fast_two_sum(sh, sl + tl)


def _dd_add_d(ah, al, b):
    sh, sl = two_sum(ah, b)
    return _fast_two_sum(sh, sl + al)


def _dd_mul(ah, al, bh, bl):
    p, e = two_prod(ah, bh)
    return _fast_two_sum(p, e + (ah * bl + al * bh))


def _dd_mul_d(ah, al, b):
    p, e = two_prod(ah, b)
    return _fast_two_sum(p, e + al * b)


def _pow2(e):
    """2^e for int64 e in [−1022, 1023], built from its bits."""
    return ((e + 1023) << 52).view(torch.float64)


def exp_dd(ah: torch.Tensor, al: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """e^(ah + al) as a df64 pair of f64 tensors, for ah in [ARG_MIN, 709]
    (relative error ~1e-31 above e^a ~ 1e-287; below, the pair's low part is
    subnormal, an absolute error under 1e-320): QD's dd_real exp with a
    fixed number of terms. m = rint(a/ln2), r = (a − m·ln2)/2^9, the Taylor
    series of e^r − 1 to r^8/8!, nine doublings s ← 2s + s², then (1 + s)·2^m
    as two exact scalings (the second only below the normal range). Every
    operation is the kernel's, in its order."""
    m = torch.round(ah * _INV_LN2)
    p, e = two_prod(m, _LN2[0])
    mh, ml = _fast_two_sum(p, e + m * _LN2[1])
    rh, rl = _dd_add(ah, al, -mh, -ml)
    rh, rl = rh * 2.0 ** -_HALVINGS, rl * 2.0 ** -_HALVINGS
    ph, pl = _dd_mul(rh, rl, rh, rl)
    sh, sl = _dd_add(rh, rl, ph * 0.5, pl * 0.5)
    ph, pl = _dd_mul(ph, pl, rh, rl)
    th, tl = _dd_mul(ph, pl, *_INV_FACT[0])
    for f in _INV_FACT[1:]:
        sh, sl = _dd_add(sh, sl, th, tl)
        ph, pl = _dd_mul(ph, pl, rh, rl)
        th, tl = _dd_mul(ph, pl, *f)
    sh, sl = _dd_add(sh, sl, th, tl)
    for _ in range(_HALVINGS):
        qh, ql = _dd_mul(sh, sl, sh, sl)
        sh, sl = _dd_add(sh * 2.0, sl * 2.0, qh, ql)
    sh, sl = _dd_add_d(sh, sl, 1.0)
    ei = m.to(torch.int64)
    low = ei < -1022
    s1, s2 = _pow2(torch.where(low, ei + 64, ei)), _pow2(torch.where(low, -64, 0))
    return sh * s1 * s2, sl * s1 * s2


def _grid_step(kappa: float, n_grid: int) -> Tuple[float, float]:
    """The grid's step in log x, log(κ)/(n_grid − 1) in longdouble as the
    host function's linspace takes it, as an (hi, lo) f64 pair."""
    if n_grid == 1:
        return 0.0, 0.0
    h = np.log(np.longdouble(kappa)) / np.longdouble(n_grid - 1)
    hi = float(h)
    return hi, float(h - np.longdouble(hi))


def _sup_residuals(omega: torch.Tensor, alpha: torch.Tensor, h: Tuple[float, float], n_grid: int,
                   device="cpu") -> torch.Tensor:
    """Plain version: |1 − x_i·g(x_i)| rounded to f64 for every grid point,
    the kernel's operations on f64 tensors on `device` (each its own rounded
    op, so the CPU and the card give the kernel's bits), the terms summed in
    order."""
    t = omega.numel()
    om, al = omega.to(device)[:, None], alpha.to(device)[:, None]
    r = torch.empty(n_grid, dtype=torch.float64, device=device)
    step = max(1, _CHUNK // max(t, 1))
    for lo in range(0, n_grid, step):
        i = torch.arange(lo, min(lo + step, n_grid), dtype=torch.float64, device=device)
        p, e = two_prod(i, h[0])
        xh, xl = exp_dd(*_fast_two_sum(p, e + h[1] * i))
        ah, al_ = _dd_mul_d(xh[None], xl[None], al)                       # α_j·x_i, (t, points)
        keep = ah <= -ARG_MIN
        eh, el = exp_dd(torch.where(keep, -ah, 0.0), torch.where(keep, -al_, 0.0))
        wh, wl = _dd_mul_d(eh, el, om)
        gh, gl = torch.zeros_like(xh), torch.zeros_like(xh)
        for j in range(t):
            nh, nl = _dd_add(gh, gl, wh[j], wl[j])
            gh, gl = torch.where(keep[j], nh, gh), torch.where(keep[j], nl, gl)
        qh, ql = _dd_mul(xh, xl, gh, gl)
        r[lo:lo + i.numel()] = _dd_add_d(-qh, -ql, 1.0)[0].abs()
    return r


def _sup_cuda(omega: torch.Tensor, alpha: torch.Tensor, h: Tuple[float, float], n_grid: int,
              device: torch.device) -> torch.Tensor:
    out = torch.zeros((), dtype=torch.float64, device=device)
    lib = _build.kernels()
    with torch.cuda.device(out.device):
        err = lib.tk_expsum_sup_f64(omega.data_ptr(), alpha.data_ptr(), omega.numel(), h[0], h[1], n_grid,
                                    out.data_ptr(), _build.stream_of(out))
    _build.check(err, "expsum_sup")
    _build.launches["expsum_sup"] += 1
    return out


def _terms(omega, alpha) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nonzero terms, checked: host f64 tensors of one length."""
    for name, v in (("omega", omega), ("alpha", alpha)):
        if not torch.is_tensor(v) or v.dtype != torch.float64 or v.device.type != "cpu" or v.dim() != 1:
            raise TypeError(f"{name} must be a 1-D f64 tensor on the CPU (the kernel takes the terms by value), "
                            f"got {type(v).__name__} {getattr(v, 'dtype', '')} {tuple(getattr(v, 'shape', ()))}")
    if omega.shape != alpha.shape:
        raise ValueError(f"omega and alpha must have one length, got {omega.numel()} and {alpha.numel()}")
    keep = omega != 0.0
    omega, alpha = omega[keep].contiguous(), alpha[keep].contiguous()
    if omega.numel() > MAX_TERMS:
        raise ValueError(f"at most {MAX_TERMS} nonzero terms, got {omega.numel()}")
    if not (bool(torch.isfinite(omega).all()) and bool(torch.isfinite(alpha).all()) and bool((alpha >= 0).all())):
        raise ValueError("omega must be finite and alpha finite and non-negative")
    return omega, alpha


def expsum_sup_error_dd(omega: torch.Tensor, alpha: torch.Tensor, kappa: float, n_grid: int = N_GRID,
                        device="cpu") -> float:
    """sup_{x ∈ [1, κ]} |1 − x·Σ_j ω_j e^{−α_j x}| on deflate.expsum_sup_error's
    n_grid-point log-spaced grid, in df64 (~106 bits, where the host function's
    longdouble carries 64; the two agree to its ~1e-19 absolute).

    omega, alpha: (t,) f64 tensors on the CPU (zero ω_j are left out; at most
    MAX_TERMS remain, α ≥ 0); e^{−α_j x} below e^{ARG_MIN} counts as 0. On a
    CUDA device one launch of csrc/expsum_sup.cu and one 8-byte read; on the
    CPU the plain version. Any other device raises."""
    omega, alpha = _terms(omega, alpha)
    kappa, n_grid = float(kappa), int(n_grid)
    if not (math.isfinite(kappa) and kappa > 0 and abs(math.log(kappa)) <= LOG_KAPPA_MAX):
        raise ValueError(f"kappa must be finite with |log κ| <= {LOG_KAPPA_MAX}, got {kappa}")
    if n_grid < 1:
        raise ValueError(f"n_grid must be >= 1, got {n_grid}")
    device = torch.device(device)
    h = _grid_step(kappa, n_grid)
    if device.type == "cuda":
        return host_read(_sup_cuda(omega, alpha, h, n_grid, device), float)
    if device.type == "cpu":
        return host_read(torch.max(_sup_residuals(omega, alpha, h, n_grid)), float)
    raise ValueError(f"expsum_sup_error_dd runs on cuda or cpu, got {device}")


# f64 operations (an FMA counted as two) of the df64 primitives, as the kernel issues them
_OPS_TWO_SUM, _OPS_FAST, _OPS_TWO_PROD = 6, 3, 3
_OPS_ADD = 2 * _OPS_TWO_SUM + 2 * (1 + _OPS_FAST)                     # dd + dd: 20
_OPS_ADD_D = _OPS_TWO_SUM + 1 + _OPS_FAST                             # dd + f64: 10
_OPS_MUL = _OPS_TWO_PROD + 4 + _OPS_FAST                              # dd · dd: 10
_OPS_MUL_D = _OPS_TWO_PROD + 2 + _OPS_FAST                            # dd · f64: 8
_OPS_EXP = (1 + _OPS_MUL_D + _OPS_ADD + 2                             # reduction, / 2^9
            + _OPS_MUL + 2 + _OPS_ADD + 2 * _OPS_MUL                  # r², s, r³, r³/3!
            + 5 * (_OPS_ADD + 2 * _OPS_MUL) + _OPS_ADD                # to r^8/8!
            + _HALVINGS * (2 + _OPS_MUL + _OPS_ADD)                   # s ← 2s + s²
            + _OPS_ADD_D + 4)                                         # 1 + s, · 2^m: 605


def expsum_sup_ops(omega, alpha, kappa: float, n_grid: int = N_GRID) -> int:
    """The f64 operations the kernel issues for these inputs: per point the
    grid's exp and 1 − x·g, per term not skipped α·x, its exp, ω·e and the
    sum (x computed here in f64, which can move a term that lies at the skip
    threshold to a ~1e-16 relative)."""
    omega, alpha = _terms(omega, alpha)
    x = np.exp(np.linspace(0.0, np.log(float(kappa)), int(n_grid)))
    kept = int(sum(np.count_nonzero(a * x <= -ARG_MIN) for a in alpha.tolist()))
    per_point = _OPS_MUL_D + _OPS_EXP + _OPS_MUL + _OPS_ADD_D
    per_term = _OPS_MUL_D + _OPS_EXP + _OPS_MUL_D + _OPS_ADD
    return int(n_grid) * per_point + kept * per_term
