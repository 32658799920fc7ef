"""Eigendecomposition of upper Hessenberg matrices: the nonsymmetric
check's eig (``ops/expsum.cp_solve_nonsym_eig``) for Arnoldi's H.

``hess_eig(H, k)`` takes H (d, K, K) f64, upper Hessenberg in its active
k×k blocks, and returns their eigenvalues w (d, k) complex, right
eigenvectors V (d, k, k) complex (columns of unit 2-norm, a conjugate pair's
vectors conjugate columns) and info (d,) int32, nonzero where the QR
iteration did not converge (LAPACK's convention: one more than the row at
which it stopped). Entries of the active block below the subdiagonal are
read as zero.

The algorithm is LAPACK's, in f64: ``dlahqr``'s implicit Francis
double-shift QR on the Hessenberg with its Schur vectors Z (the
Ahues–Kressner small-subdiagonal test, the exceptional shifts after 10 and
20 iterations without a deflation, ``dlanv2`` on each 2×2 block), then
``dtrevc3``'s back-substitution on the quasi-triangular Schur factor T for
each eigenvalue (small pivots raised to smin), back-transformed by Z. Two
things differ from LAPACK: the iteration cap, 30·max(10, k) iterations, is
on the whole factor and not on each deflation window, and ``dlarfg``'s and
``dlanv2``'s rescaling of operands near the underflow and overflow limits is
left out (a vector is instead scaled down where an entry passes 2^500). The
kernel forms each reflector's τ and scale from one reciprocal square root
(the same reflector, rounded otherwise; the plain version keeps dlarfg's
formulas), so the two agree to rounding, not bit for bit.

On a CUDA tensor one launch of ``csrc/hess_eig.cu`` takes every factor (one
thread block each) and writes Z and the eigenvectors X of T; V = Z·X is one
complex batched GEMM. On a CPU tensor the plain version below runs the same
sweeps and tests, as Python loops over torch ops, one factor at a time.

``hess_eig_solve(H, k, b)`` also returns g = V⁻¹ b without factoring V:
V = Z·X·N⁻¹ (N the columns' norms), so g = N·X⁻¹·Zᵀ b, and X is upper
triangular but for each conjugate pair's entry X[c+1, c]. A column operation
of modulus one per pair (X' = X·Q, column c − ρ_c·column c+1 with
ρ_c = X[c+1, c]/X[c+1, c+1], |ρ_c| = 1) clears it, so X⁻¹ = Q·X'⁻¹ is one
batched triangular solve.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from . import _build

__all__ = ["hess_eig", "hess_eig_solve", "hess_eig_reference", "HessEig", "MAX_K", "ITER_CAP_PER_ROW"]

MAX_K = 1024                  # the kernel's largest active size (its shared reflector list)
ITER_CAP_PER_ROW = 30         # dlahqr's ITMAX = 30·max(10, k)
ULP = 2.0 ** -52              # dlamch('P')
SAFMIN = 2.0 ** -1022         # dlamch('S')
BIG = 2.0 ** 500              # an eigenvector is scaled down where an entry passes this
_DAT1, _DAT2, _KEXSH = 0.75, -0.4375, 10


class HessEig(NamedTuple):
    w: torch.Tensor       # (d, k) complex128
    V: torch.Tensor       # (d, k, k) complex128, unit columns
    info: torch.Tensor    # (d,) int32


def _check(H: torch.Tensor, k: int) -> None:
    if not torch.is_tensor(H) or H.dtype != torch.float64:
        raise TypeError(f"hess_eig takes an f64 tensor H, got {getattr(H, 'dtype', type(H).__name__)}")
    if H.dim() != 3 or H.shape[1] != H.shape[2] or H.shape[0] < 1:
        raise ValueError(f"H must be (d, K, K) with d >= 1, got {tuple(H.shape)}")
    if not 1 <= k <= H.shape[1]:
        raise ValueError(f"the active size k={k} must lie in 1..K={H.shape[1]}")


def _vectors(Z: torch.Tensor, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """V = Z·X with unit columns, and the norms it was divided by: Z
    (d, k, k) real Schur vectors, X (d, k, k) complex eigenvectors of T."""
    V = torch.matmul(Z.to(X.dtype), X)
    nrm = torch.linalg.vector_norm(V, dim=1, keepdim=True)
    return V / nrm, nrm[:, 0]


def _parts(H: torch.Tensor, k: int):
    """(w, Z, X, info): the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    k = int(k)
    _check(H, k)
    if H.device.type == "cuda":
        return _hess_eig_cuda(H, k)[:4]
    if H.device.type == "cpu":
        return _hess_eig_plain(H, k)[:4]
    raise ValueError(f"hess_eig runs on cuda or cpu tensors, got {H.device}")


def hess_eig(H: torch.Tensor, k: int) -> HessEig:
    """Eigenvalues, unit right eigenvectors and the convergence info of the
    active k×k blocks of H (d, K, K) f64 (the module's contract): the CUDA
    kernel for a CUDA tensor (k ≤ MAX_K), the plain version for a CPU
    tensor; any other device raises. Nothing here waits for the card: a
    caller reads info when it reads its other results."""
    w, Z, X, info = _parts(H, k)
    return HessEig(w, _vectors(Z, X)[0], info)


def hess_eig_solve(H: torch.Tensor, k: int, b: torch.Tensor) -> Tuple[HessEig, torch.Tensor]:
    """hess_eig, and g = V⁻¹ b (d, k, R) complex for b (d, k, R) through the
    triangular X (the module's note): no factorization of V, nothing that
    waits for the card."""
    w, Z, X, info = _parts(H, k)
    V, nrm = _vectors(Z, X)
    y = torch.matmul(Z.transpose(1, 2), b.to(Z.dtype)).to(X.dtype)          # Zᵀ b
    rho = torch.zeros_like(w)                  # ρ_c at each pair's first column c, else 0
    rho[:, :-1] = torch.where(w.imag[:, :-1] > 0.0,
                              torch.diagonal(X, -1, 1, 2) / torch.diagonal(X, 0, 1, 2)[:, 1:], 0.0)
    Xq = X.clone()
    Xq[:, :, :-1] -= rho[:, None, :-1] * X[:, :, 1:]                         # X' = X·Q
    v = torch.linalg.solve_triangular(Xq, y, upper=True)                      # X'⁻¹ Zᵀ b
    v[:, 1:] -= rho[:, :-1, None] * v[:, :-1].clone()                         # Q·v
    return HessEig(w, V, info), v * nrm[:, :, None]


def hess_eig_reference(H: torch.Tensor, k: int) -> HessEig:
    """The plain version on any device (on a CUDA tensor every scalar
    decision is a read of the card: slow, for comparisons only)."""
    k = int(k)
    _check(H, k)
    w, Z, X, info, _ = _hess_eig_plain(H, k)
    return HessEig(w, _vectors(Z, X)[0], info)


def _hess_eig_cuda(H: torch.Tensor, k: int, stats: bool = False):
    """The kernel's launch. Returns w (d, k) complex, Z (d, k, k), X (d, k, k)
    complex, info (d,) int32 and, where stats is asked for (a measurement),
    stats (d, 3) int64: QR iterations, bulge steps, and the f64 operations
    of the sweeps, rotations and back-substitution (an FMA counted as two);
    else None."""
    if k > MAX_K:
        raise ValueError(f"the hess_eig kernel takes k <= {MAX_K}, got k={k}")
    H = H.contiguous()
    d, K, _ = H.shape
    T = torch.empty((d, k, k), dtype=torch.float64, device=H.device)
    Zc = torch.empty_like(T)                        # Zc[f, c, r] = Z[r, c]
    w = torch.empty((d, k, 2), dtype=torch.float64, device=H.device)
    Xc = torch.empty((d, k, k, 2), dtype=torch.float64, device=H.device)   # Xc[f, c, r] = X[r, c]
    info = torch.empty((d,), dtype=torch.int32, device=H.device)
    counts = torch.empty((d, 3), dtype=torch.int64, device=H.device) if stats else None
    lib = _build.kernels()
    with torch.cuda.device(H.device):
        err = lib.tk_hess_eig_f64(H.data_ptr(), d, K, k, T.data_ptr(), Zc.data_ptr(), w.data_ptr(), Xc.data_ptr(),
                                  info.data_ptr(), counts.data_ptr() if stats else None, _build.stream_of(H))
    _build.check(err, "hess_eig")
    _build.launches["hess_eig"] += 1
    return (torch.view_as_complex(w), Zc.transpose(1, 2), torch.view_as_complex(Xc).transpose(1, 2), info, counts)


# ---- the plain version -------------------------------------------------------


def _hess_eig_plain(H: torch.Tensor, k: int):
    """The plain version, one factor at a time: _hess_eig_cuda's returns, with
    stats (d, 2) the QR iterations and bulge steps."""
    d = H.shape[0]
    dev = H.device
    w = torch.zeros((d, k), dtype=torch.complex128, device=dev)
    Z = torch.zeros((d, k, k), dtype=torch.float64, device=dev)
    X = torch.zeros((d, k, k), dtype=torch.complex128, device=dev)
    info = torch.zeros((d,), dtype=torch.int32, device=dev)
    stats = torch.zeros((d, 2), dtype=torch.int64, device=dev)
    for f in range(d):
        T = torch.triu(H[f, :k, :k], -1)
        Zf = torch.eye(k, dtype=torch.float64, device=dev)
        wr, wi, inf, st = _lahqr(T, Zf)
        info[f], Z[f] = inf, Zf
        if inf == 0:
            w[f] = torch.complex(torch.tensor(wr, dtype=torch.float64), torch.tensor(wi, dtype=torch.float64)).to(dev)
            X[f] = _trevc(T, wr, wi)
        stats[f] = torch.tensor(st)
    return w, Z, X, info, stats


def _sign(a: float, b: float) -> float:
    return math.copysign(abs(a), b)


def _larfg(alpha: float, x: List[float]):
    """dlarfg on (alpha, x), len(x) 1 or 2: (beta, v (the scaled x), tau)."""
    xnorm = math.hypot(*x) if len(x) == 2 else abs(x[0])
    if xnorm == 0.0:
        return alpha, list(x), 0.0
    beta = -_sign(math.hypot(alpha, xnorm), alpha)
    tau = (beta - alpha) / beta
    sc = 1.0 / (alpha - beta)
    return beta, [xi * sc for xi in x], tau


def _lanv2(a, b, c, d):
    """dlanv2: the 2×2 block [[a, b], [c, d]] in standard Schur form, its
    eigenvalues and the rotation (cs, sn)."""
    if c == 0.0:
        cs, sn = 1.0, 0.0
    elif b == 0.0:
        cs, sn = 0.0, 1.0
        a, d = d, a
        b, c = -c, 0.0
    elif (a - d) == 0.0 and math.copysign(1.0, b) != math.copysign(1.0, c):
        cs, sn = 1.0, 0.0
    else:
        temp = a - d
        p = 0.5 * temp
        bcmax = max(abs(b), abs(c))
        bcmis = min(abs(b), abs(c)) * math.copysign(1.0, b) * math.copysign(1.0, c)
        scale = max(abs(p), bcmax)
        z = (p / scale) * p + (bcmax / scale) * bcmis
        if z >= 4.0 * ULP:
            z = p + _sign(math.sqrt(scale) * math.sqrt(z), p)
            a = d + z
            d = d - (bcmax / z) * bcmis
            tau = math.hypot(c, z)
            cs, sn = z / tau, c / tau
            b, c = b - c, 0.0
        else:
            sigma = b + c
            tau = math.hypot(sigma, temp)
            cs = math.sqrt(0.5 * (1.0 + abs(sigma) / tau))
            sn = -(p / (tau * cs)) * math.copysign(1.0, sigma)
            aa, bb = a * cs + b * sn, -a * sn + b * cs
            cc, dd = c * cs + d * sn, -c * sn + d * cs
            a, b = aa * cs + cc * sn, bb * cs + dd * sn
            c, d = -aa * sn + cc * cs, -bb * sn + dd * cs
            temp = 0.5 * (a + d)
            a = d = temp
            if c != 0.0:
                if b != 0.0:
                    if math.copysign(1.0, b) == math.copysign(1.0, c):
                        sab, sac = math.sqrt(abs(b)), math.sqrt(abs(c))
                        p = _sign(sab * sac, c)
                        tau = 1.0 / math.sqrt(abs(b + c))
                        a, d = temp + p, temp - p
                        b, c = b - c, 0.0
                        cs1, sn1 = sab * tau, sac * tau
                        cs, sn = cs * cs1 - sn * sn1, cs * sn1 + sn * cs1
                else:
                    b, c = -c, 0.0
                    cs, sn = -sn, cs
    rt1i = 0.0 if c == 0.0 else math.sqrt(abs(b)) * math.sqrt(abs(c))
    return a, b, c, d, (a, rt1i), (d, -rt1i), cs, sn


def _negligible(g, kk: int, n: int, smlnum: float) -> bool:
    """dlahqr's test of the subdiagonal T[kk, kk−1] (Ahues & Kressner)."""
    h = abs(g(kk, kk - 1))
    if h <= smlnum:
        return True
    tst = abs(g(kk - 1, kk - 1)) + abs(g(kk, kk))
    if tst == 0.0:
        if kk - 2 >= 0:
            tst += abs(g(kk - 1, kk - 2))
        if kk + 1 <= n - 1:
            tst += abs(g(kk + 1, kk))
    if h <= ULP * tst:
        up = abs(g(kk - 1, kk))
        ab, ba = max(h, up), min(h, up)
        dk, diff = abs(g(kk, kk)), abs(g(kk - 1, kk - 1) - g(kk, kk))
        aa, bb = max(dk, diff), min(dk, diff)
        s = aa + ab
        if ba * (ab / s) <= max(smlnum, ULP * (bb * (aa / s))):
            return True
    return False


def _shifts(g, l: int, i: int, kdefl: int):
    """The double shift (rt1r, rt1i, rt2r, rt2i): the trailing 2×2 block's
    eigenvalues, or an exceptional pair every 10th/20th iteration."""
    if kdefl % (2 * _KEXSH) == 0:
        s = abs(g(i, i - 1)) + abs(g(i - 1, i - 2))
        h11 = _DAT1 * s + g(i, i)
        h12, h21, h22 = _DAT2 * s, s, h11
    elif kdefl % _KEXSH == 0:
        s = abs(g(l + 1, l)) + abs(g(l + 2, l + 1))
        h11 = _DAT1 * s + g(l, l)
        h12, h21, h22 = _DAT2 * s, s, h11
    else:
        h11, h21, h12, h22 = g(i - 1, i - 1), g(i, i - 1), g(i - 1, i), g(i, i)
    s = abs(h11) + abs(h12) + abs(h21) + abs(h22)
    if s == 0.0:
        return 0.0, 0.0, 0.0, 0.0
    h11, h21, h12, h22 = h11 / s, h21 / s, h12 / s, h22 / s
    tr = (h11 + h22) / 2.0
    det = (h11 - tr) * (h22 - tr) - h12 * h21
    rtdisc = math.sqrt(abs(det))
    if det >= 0.0:
        return tr * s, rtdisc * s, tr * s, -(rtdisc * s)
    rt1r, rt2r = tr + rtdisc, tr - rtdisc
    rt = rt1r * s if abs(rt1r - h22) <= abs(rt2r - h22) else rt2r * s
    return rt, 0.0, rt, 0.0


def _shift_vector(g, m: int, sh):
    """First column of (T − σ1)(T − σ2) at row m, scaled (dlahqr's V)."""
    rt1r, rt1i, rt2r, rt2i = sh
    h21s = g(m + 1, m)
    s = abs(g(m, m) - rt2r) + abs(rt2i) + abs(h21s)
    h21s = g(m + 1, m) / s
    v1 = h21s * g(m, m + 1) + (g(m, m) - rt1r) * ((g(m, m) - rt2r) / s) - rt1i * (rt2i / s)
    v2 = h21s * (g(m, m) + g(m + 1, m + 1) - rt1r - rt2r)
    v3 = h21s * g(m + 2, m + 1)
    s = abs(v1) + abs(v2) + abs(v3)
    return v1 / s, v2 / s, v3 / s


def _lahqr(T: torch.Tensor, Z: torch.Tensor):
    """dlahqr with wantt and wantz on T (k, k) upper Hessenberg, in place:
    T becomes quasi-triangular, Z (k, k) accumulates the transformations.
    Returns (wr, wi, info, [iterations, bulge steps])."""
    n = T.shape[0]
    wr, wi = [0.0] * n, [0.0] * n
    st = [0, 0]

    def g(r, c):
        return float(T[r, c])

    smlnum = SAFMIN * (n / ULP)
    itmax = ITER_CAP_PER_ROW * max(10, n)
    its = kdefl = 0
    i = n - 1
    while i >= 0:
        l = 0
        while True:
            kk = i
            while kk > l and not _negligible(g, kk, n, smlnum):
                kk -= 1
            l = kk
            if l > 0:
                T[l, l - 1] = 0.0
            if l >= i - 1:
                break
            if its >= itmax:
                return wr, wi, i + 1, st
            its += 1
            kdefl += 1
            sh = _shifts(g, l, i, kdefl)
            m = i - 2
            while m > l:
                v1, v2, v3 = _shift_vector(g, m, sh)
                h00 = abs(g(m, m - 1)) * (abs(v2) + abs(v3))
                h01 = abs(v1) * (abs(g(m - 1, m - 1)) + abs(g(m, m)) + abs(g(m + 1, m + 1)))
                if h00 <= ULP * h01:
                    break
                m -= 1
            _sweep(T, Z, l, m, i, _shift_vector(g, m, sh), st)
        if l == i:
            wr[i] = g(i, i)
        else:
            a, b, c, d, (wr[i - 1], wi[i - 1]), (wr[i], wi[i]), cs, sn = _lanv2(g(i - 1, i - 1), g(i - 1, i),
                                                                                 g(i, i - 1), g(i, i))
            T[i - 1, i - 1], T[i - 1, i], T[i, i - 1], T[i, i] = a, b, c, d
            for x, y in ((T[i - 1, i + 1:], T[i, i + 1:]), (T[:i - 1, i - 1], T[:i - 1, i]), (Z[:, i - 1], Z[:, i])):
                x_new = cs * x + sn * y
                y.copy_(cs * y - sn * x)
                x.copy_(x_new)
        kdefl = 0
        i = l - 1
    return wr, wi, 0, st


def _sweep(T, Z, l: int, m: int, i: int, v, st) -> None:
    """One double-shift QR sweep over rows and columns m..i (dlahqr's loop
    130), the reflectors applied to every column right of it and every row
    above it (wantt) and to Z."""
    n = T.shape[0]
    st[0] += 1
    beta = 0.0
    for s in range(m, i):
        nr = min(3, i - s + 1)
        if s > m:
            v = [float(T[s + a, s - 1]) for a in range(nr)]
        beta, x, t1 = _larfg(v[0], list(v[1:nr]))
        if s > m:
            T[s, s - 1] = beta
            T[s + 1, s - 1] = 0.0
            if s < i - 1:
                T[s + 2, s - 1] = 0.0
        elif m > l:
            T[s, s - 1] = float(T[s, s - 1]) * (1.0 - t1)
        tv = torch.tensor([t1] + [t1 * xi for xi in x], dtype=T.dtype, device=T.device)
        vv = torch.tensor([1.0] + x, dtype=T.dtype, device=T.device)
        rows = T[s:s + nr, s:]                              # from the left, columns s..n−1
        rows -= torch.outer(tv, vv @ rows)
        cols = T[:min(s + 3, i) + 1, s:s + nr]              # from the right, rows 0..min(s+3, i)
        cols -= torch.outer(cols @ vv, tv)
        zc = Z[:, s:s + nr]
        zc -= torch.outer(zc @ vv, tv)
        st[1] += 1


def _trevc(T: torch.Tensor, wr: List[float], wi: List[float]) -> torch.Tensor:
    """Right eigenvectors X (k, k) complex of the quasi-triangular T
    (dtrevc3's back-substitution, all eigenvalues at once, one row or 2×2
    block of rows at a time), each column scaled so that its largest entry
    has |re| + |im| = 1; a conjugate pair's columns conjugate."""
    n = T.shape[0]
    dev = T.device
    smlnum = SAFMIN * (n / ULP)
    X = torch.zeros((n, n), dtype=torch.complex128, device=dev)
    lam = torch.complex(torch.tensor(wr, dtype=torch.float64), torch.tensor(wi, dtype=torch.float64)).to(dev)
    smin = torch.clamp(ULP * (torch.tensor(wr).abs() + torch.tensor(wi).abs()), min=smlnum).to(dev)
    start = torch.arange(n, device=dev)           # the first row of each column's own block
    solved = torch.tensor([x >= 0.0 for x in wi], device=dev)
    for c in range(n):
        if wi[c] == 0.0:
            X[c, c] = 1.0
        elif wi[c] > 0.0:
            if abs(float(T[c, c + 1])) >= abs(float(T[c + 1, c])):
                X[c, c], X[c + 1, c] = 1.0, complex(0.0, wi[c] / float(T[c, c + 1]))
            else:
                X[c, c], X[c + 1, c] = -wi[c] / float(T[c + 1, c]), 1j
    j = n - 1
    while j >= 0:
        two = j > 0 and float(T[j, j - 1]) != 0.0
        j1 = j - 1 if two else j
        act = solved & (start > j)
        if bool(act.any()):
            Tc = T.to(X.dtype)
            r = -(Tc[j1:j + 1, j + 1:] @ X[j + 1:])                     # (rows, n)
            if two:
                a11, a12 = Tc[j - 1, j - 1] - lam, Tc[j - 1, j].expand(n)
                a21, a22 = Tc[j, j - 1].expand(n), Tc[j, j] - lam
                cmax = torch.stack([_abs1(a) for a in (a11, a12, a21, a22)]).amax(0)
                det = a11 * a22 - a12 * a21
                det = torch.where(_abs1(det) < smin * cmax, (smin * cmax).to(det.dtype), det)
                x1, x2 = (r[0] * a22 - a12 * r[1]) / det, (a11 * r[1] - a21 * r[0]) / det
                tiny = cmax < smin
                x1 = torch.where(tiny, r[0] / smin, x1)
                x2 = torch.where(tiny, r[1] / smin, x2)
                new = torch.stack([x1, x2])
            else:
                den = Tc[j, j] - lam
                den = torch.where(_abs1(den) < smin, smin.to(den.dtype), den)
                new = (r[0] / den)[None]
            X[j1:j + 1] = torch.where(act[None], new, X[j1:j + 1])
            big = _abs1(new).amax(0)
            scale = torch.where(act & (big > BIG), 1.0 / big, torch.ones_like(big))
            X *= scale[None]
        j = j1 - 1
    emax = torch.where(solved, _abs1(X).amax(0), torch.ones(n, dtype=torch.float64, device=dev))
    X /= emax[None]
    for c in range(n - 1):
        if wi[c] > 0.0:
            X[:, c + 1] = X[:, c].conj()
    return X


def _abs1(z: torch.Tensor) -> torch.Tensor:
    return z.real.abs() + z.imag.abs()
