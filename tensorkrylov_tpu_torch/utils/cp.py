"""CP-tensor utilities: counterpart of ``tensorkrylov_tpu/utils/cp.py``.

Norms and inner products, the low-rank operator algebra (``kron_apply_cp``,
``cp_axpy``, ``cp_round``), the residual cross-checks, and the dense oracles.
Tensors stay on their device; the cancellative rank-pair sums of the accurate
forms run on the host in numpy ``longdouble`` (80-bit on x86), as in the JAX
package.

``cp_residual_cross_check_device`` forms the Gram of the residual's distinct
columns [B | X | A X] on X's device in native f64, each entry a compensated
dot product (``_gram_dot2``: an f64 pair carrying it to ~eps², whatever n is),
with A X from ``ops.banded.spmv``; the host adds each pair in longdouble, and
the floor charges longdouble eps. An f64 GEMM carries a length-n entry only to
~√n·eps, and at d=10, n ≥ 16384 its noise in the cancelling pair sum already
reads above an f64-eps floor where the residual is far below it. The JAX
package's f32-pair GEMM, its
column chunking, its 1e-15 charge and its mesh branch work around the TPU's
emulated f64 and are not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.gallery import bands_to_dense
from ..ops.banded import spmv
from ..parallel.krylov import spmv_pieces, whole
from ..parallel.sharding import ShardedOperator, shard_rhs
from ..types import CPTensor, KroneckerSumOperator
from .profiling import host_read

__all__ = [
    "cp_dot",
    "cp_norm",
    "cp_dot_accurate",
    "cp_norm_accurate",
    "cp_residual_cross_check",
    "cp_residual_cross_check_device",
    "cp_residual_cross_check_host",
    "cp_residual_cross_check_host_rankR",
    "cp_residual_norm_accurate",
    "host_spmv_bands",
    "ResidualCrossCheck",
    "cp_full",
    "cp_compress",
    "cp_axpy",
    "cp_round",
    "kron_apply_cp",
    "kron_matvec_dense",
    "kron_residual_dense",
]

_F64_EPS = float(np.finfo(np.float64).eps)
_LD_EPS = float(np.finfo(np.longdouble).eps)


def _host(t) -> np.ndarray:
    """A tensor or array as a host f64 numpy array."""
    if torch.is_tensor(t):
        t = host_read(t.detach()).numpy()
    return np.asarray(t, np.float64)


def cp_compress(x: CPTensor, rel_tol: float = 0.0) -> CPTensor:
    """Drop CP terms with (near-)zero weight, e.g. the padded columns of a
    solver result. rel_tol is relative to the largest |weight|."""
    w = x.weights
    if w.numel() == 0:
        return x
    aw = torch.abs(w)
    keep = aw > rel_tol * aw.max()
    if not bool(keep.any()):
        keep = aw == aw.max()
    return CPTensor(w[keep], x.factors[:, :, keep])


def cp_dot(x: CPTensor, y: CPTensor) -> torch.Tensor:
    """⟨x, y⟩ = Σ_{ij} λ_i μ_j Π_s ⟨x_s[:,i], y_s[:,j]⟩ — O(d·t²·n)."""
    G = torch.einsum("dni,dnj->dij", x.factors, y.factors)
    return x.weights @ torch.prod(G, dim=0) @ y.weights


def cp_norm(x: CPTensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(cp_dot(x, x), min=0.0))


def cp_dot_accurate(x: CPTensor, y: CPTensor) -> float:
    """⟨x, y⟩ with the rank-pair contraction in extended precision: the
    per-mode Gram matrices in f64 on the factors' device (length-n inner
    products, benign), the product over modes and the weighted sum over rank
    pairs (cancellative when the terms are large and cancel) on the host in
    numpy longdouble."""
    G = torch.einsum("dni,dnj->dij", x.factors.to(torch.float64), y.factors.to(torch.float64))
    P = np.prod(_host(G).astype(np.longdouble), axis=0)
    wx = _host(x.weights).astype(np.longdouble)
    wy = _host(y.weights).astype(np.longdouble)
    return float(wx @ P @ wy)


def cp_norm_accurate(x: CPTensor) -> float:
    """‖x‖ via cp_dot_accurate (extended-precision pair contraction)."""
    return float(np.sqrt(max(cp_dot_accurate(x, x), 0.0)))


class ResidualCrossCheck(NamedTuple):
    """Basis-free residual measurement plus its own validity floor.

    `value` is the measured ‖b − A x‖; `floor` = √(eps · mass), where `mass`
    = Σ_{ij} |w_i w_j| Π_s |G_s[i,j]| is the CP term mass the rank-pair
    contraction cancelled against and eps the relative error of the Gram
    entries. A value at or below `floor` means "≤ floor", not the printed
    value."""

    value: float
    floor: float

    def interpret(self) -> str:
        if self.value <= self.floor:
            return f"<= floor {self.floor:.3e} (below measurement floor)"
        return f"{self.value:.3e} (floor {self.floor:.3e})"


def host_spmv_bands(bands: np.ndarray, offsets, V: np.ndarray) -> np.ndarray:
    """Numpy twin of ops.banded.spmv for (d, n, t) column blocks: out[s,:,j]
    = A_s V[s,:,j]."""
    d, nb, n = bands.shape
    out = np.zeros_like(V)
    for bidx, off in enumerate(offsets):
        col = bands[:, bidx, :]                                # (d, n)
        if off == 0:
            out += col[:, :, None] * V
        elif off > 0:
            out[:, : n - off, :] += col[:, : n - off, None] * V[:, off:, :]
        else:
            out[:, -off:, :] += col[:, -off:, None] * V[:, : n + off, :]
    return out


def cp_residual_cross_check_host(bands, offsets, weights, factors, b) -> ResidualCrossCheck:
    """Pure-numpy core of cp_residual_cross_check (all inputs host arrays)."""
    X = np.asarray(factors, np.float64)
    d, n, t = X.shape
    b = np.asarray(b, np.float64)
    AX = host_spmv_bands(np.asarray(bands, np.float64), offsets, X)
    C = np.concatenate([b[:, :, None], X, AX], axis=2)         # (d, n, 1+2t)
    G_small = np.einsum("dni,dnj->dij", C, C).astype(np.longdouble)
    return _cross_check_from_gram(G_small, np.asarray(weights, np.float64), d, t)


def cp_residual_cross_check(op: KroneckerSumOperator, x: CPTensor, b) -> ResidualCrossCheck:
    """‖b − A x‖ with a validity floor, on the host, without materializing the
    rank-(1+d·t) residual: its mode-s factor matrix has only 1+2t distinct
    columns [b_s | X_s | A_s X_s], so its (1+d·t)² Gram matrix is an indexed
    view of the (1+2t)² Gram of those columns. The rank-pair contraction runs
    in host longdouble, as cp_dot_accurate's."""
    return cp_residual_cross_check_host(_host(op.bands), op.offsets, _host(x.weights), _host(x.factors), _host(b))


def cp_residual_cross_check_device(op: KroneckerSumOperator, weights, X_dev, b_dev) -> ResidualCrossCheck:
    """cp_residual_cross_check with the O(d·n·t²) Gram formed on X's device,
    compensated (_gram_dot2), only the small (d, R+2t, R+2t) Gram, as f64
    pairs, moving to the host for the longdouble rank-pair contraction. A X
    is one banded SpMV of the (d, t, n) columns. X_dev: (d, n, t) solution
    factors; b_dev: (d, n) for a rank-1 right-hand side, or (R, d, n) for
    b = Σ_r ⊗_s b_dev[r, s] (the block solvers' residual). The floor charges
    longdouble eps on the Gram entries."""
    X = torch.as_tensor(X_dev).to(torch.float64)
    dev = X.device
    d, n, t = X.shape
    b = torch.as_tensor(b_dev).to(device=dev, dtype=torch.float64)
    B_rows = b[:, None, :] if b.dim() == 2 else b.transpose(0, 1)       # (d, R, n)
    R = B_rows.shape[1]
    op64 = KroneckerSumOperator(op.bands.to(device=dev, dtype=torch.float64), op.offsets, op.symmetric)
    Xt = X.transpose(1, 2).contiguous()                                  # (d, t, n)
    C = torch.cat([B_rows, Xt, spmv(op64, Xt)], dim=1)                   # (d, R+2t, n)
    hi, lo = _gram_dot2(C)
    G = _host(hi).astype(np.longdouble) + _host(lo).astype(np.longdouble)
    return _cross_check_from_gram(G, _host(weights), d, t, R=R, b_weights=np.ones(R), entry_eps=_LD_EPS)


_SPLITTER = 134217729.0   # 2^27 + 1: Dekker's split of an f64 into two halves of 26 bits


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, e) with s = fl(a + b) and a + b = s + e exactly (Knuth's TwoSum)."""
    s = a + b
    z = s - a
    return s, (a - (s - z)) + (b - z)


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """(p, e) with p = fl(a·b) and a·b = p + e exactly (Dekker's TwoProduct;
    each operation is its own rounded tensor op, none fused into an FMA)."""
    p = a * b
    ca, cb = _SPLITTER * a, _SPLITTER * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _gram_dot2(C: torch.Tensor):
    """G = C Cᵀ per batch for C (d, P, n), as (hi, lo) f64 pairs (d, P, P):
    each entry a compensated dot product (Ogita, Rump and Oishi's Dot2, its
    sum a pairwise tree of TwoSums), so hi + lo carries the entry to about
    eps²·log2(n) of Σ|c_i c_j| whatever n is, where an f64 GEMM carries it
    to about √n·eps."""
    d, P, n = C.shape
    hi = torch.zeros((d, P, P), dtype=C.dtype, device=C.device)
    lo = torch.zeros_like(hi)
    for i in range(P):
        p, e = _two_prod(C[:, i:, :], C[:, i:i + 1, :])                 # (d, P - i, n)
        while p.shape[-1] > 1:
            if p.shape[-1] % 2:
                p, e = (torch.nn.functional.pad(t, (0, 1)) for t in (p, e))
            s, err = _two_sum(p[..., 0::2], p[..., 1::2])
            p, e = s, e[..., 0::2] + e[..., 1::2] + err
        hi[:, i, i:], lo[:, i, i:] = p[..., 0], e[..., 0]
        hi[:, i:, i], lo[:, i:, i] = p[..., 0], e[..., 0]
    return hi, lo


def cp_residual_cross_check_host_rankR(bands, offsets, weights, factors, B, b_weights=None) -> ResidualCrossCheck:
    """cp_residual_cross_check_host for a rank-R tensor-product RHS
    b = Σ_r bw_r ⊗_s B[r, s] (B: (R, d, n)): per-mode distinct columns
    [B_s | X_s | A_s X_s]."""
    X = np.asarray(factors, np.float64)
    d, n, t = X.shape
    B = np.asarray(B, np.float64)
    R = B.shape[0]
    bw = np.ones(R) if b_weights is None else np.asarray(b_weights, np.float64)
    AX = host_spmv_bands(np.asarray(bands, np.float64), offsets, X)
    C = np.concatenate([np.transpose(B, (1, 2, 0)), X, AX], axis=2)    # (d, n, R+2t)
    G_small = np.einsum("dni,dnj->dij", C, C).astype(np.longdouble)
    return _cross_check_from_gram(G_small, np.asarray(weights, np.float64), d, t, R=R, b_weights=bw)


def _cross_check_from_gram(G_small, weights, d: int, t: int, R: int = 1, b_weights=None,
                           entry_eps: float = _F64_EPS) -> ResidualCrossCheck:
    # column map of the full residual factor matrix, per mode s:
    # cols 0..R-1 = B_s; col R+s'·t+j = (A_s X_s)[:, j] if s' == s else X_s[:, j]
    sp = np.repeat(np.arange(d), t)
    jj = np.tile(np.arange(t), d)
    idx = np.empty((d, R + d * t), np.int64)
    idx[:, :R] = np.arange(R)
    for s in range(d):
        idx[s, R:] = np.where(sp == s, R + t + jj, R + jj)
    # weights: r = Σ_r bw_r·b_r − Σ_{s',j} w_j · (A applied in mode s')
    bw = np.ones(R) if b_weights is None else np.asarray(b_weights, np.float64)
    w = np.concatenate([bw, -np.tile(weights, d)]).astype(np.longdouble)

    P = np.ones((R + d * t, R + d * t), np.longdouble)
    P_abs = np.ones_like(P)
    for s in range(d):
        Gs = G_small[s][np.ix_(idx[s], idx[s])]
        P *= Gs
        P_abs *= np.abs(Gs)
    aw = np.abs(w)
    mass = float(aw @ P_abs @ aw)                              # Σ|terms|, norm²
    floor = float(np.sqrt(entry_eps * max(mass, 0.0)))
    value = float(np.sqrt(max(float(w @ P @ w), 0.0)))
    return ResidualCrossCheck(value, floor)


def cp_residual_norm_accurate(op: KroneckerSumOperator, x: CPTensor, b) -> float:
    """The measured value of cp_residual_cross_check."""
    return cp_residual_cross_check(op, x, b).value


def cp_full(x: CPTensor) -> np.ndarray:
    """Materialize to a length-n^d numpy vector (tests only; tiny problems)."""
    factors = x.factors.detach().cpu().numpy()
    weights = x.weights.detach().cpu().numpy()
    d, n, t = factors.shape
    out = np.zeros(n**d)
    for j in range(t):
        acc = np.array([1.0])
        for s in range(d):
            acc = np.kron(acc, factors[s, :, j])
        out += weights[j] * acc
    return out


def _spmv_whole(op, V: torch.Tensor) -> torch.Tensor:
    """A V for V (d, m, n) whole on op's (lead) device: one banded SpMV, or
    over a ShardedOperator V split, the sharded SpMV of its pieces
    (parallel/krylov.spmv_pieces) and the result gathered."""
    if not isinstance(op, ShardedOperator):
        return spmv(op, V)
    return whole(op, spmv_pieces(op, shard_rhs(V, op.mesh, op.d, factor_axis=0)))


def kron_apply_cp(op, x: CPTensor) -> CPTensor:
    """A x in CP form: the Kronecker sum applied to a rank-t CP tensor is a
    rank-(d·t) CP tensor, term (s, j) applying A_s to mode s of term j and
    copying the other modes. All t columns of every mode go through one
    banded SpMV of (d, t, n); over a ShardedOperator, one sharded SpMV of the
    columns' pieces, x and the result whole on the lead device."""
    d, n, t = x.factors.shape
    applied = _spmv_whole(op.astype(x.factors.dtype), x.factors.transpose(1, 2).contiguous()).transpose(1, 2)
    # out factor of mode m, term (s, j): applied if m == s else original
    eye = torch.eye(d, dtype=torch.bool, device=x.factors.device)[:, None, :, None]   # (m, 1, s, 1)
    out = torch.where(eye, applied[:, :, None, :], x.factors[:, :, None, :])         # (m, n, s, t)
    return CPTensor(x.weights.expand(d, t).reshape(d * t), out.reshape(d, n, d * t))


def cp_axpy(alpha, x: CPTensor, y: CPTensor) -> CPTensor:
    """α·x + y as a CP tensor (rank t_x + t_y; no rounding)."""
    return CPTensor(torch.cat([alpha * x.weights, y.weights]), torch.cat([x.factors, y.factors], dim=2))


def _cp_round_als(weights, factors, rank: int, iters: int, ridge: float):
    d, n, T = factors.shape
    dt, dev = factors.dtype, factors.device
    # normalize the target's columns; fold their norms into the weights
    cn = torch.linalg.vector_norm(factors, dim=1)                        # (d, T)
    F = factors / torch.where(cn > 0, cn, 1.0)[:, None, :]
    w = weights * torch.prod(cn, dim=0)

    # start: the `rank` largest-|weight| terms (stable, as jnp.argsort)
    order = torch.argsort(-torch.abs(w), stable=True)[:rank]
    B = F[:, :, order]                                                   # (d, n, r)
    lam = w[order]
    ones_r = torch.ones((rank, rank), dtype=dt, device=dev)
    ones_c = torch.ones((T, rank), dtype=dt, device=dev)
    eye = torch.eye(rank, dtype=dt, device=dev)
    for _ in range(iters):
        for s in range(d):
            GB = torch.einsum("dni,dnj->dij", B, B)                      # (d, r, r)
            C = torch.einsum("dni,dnj->dij", F, B)                       # (d, T, r)
            # Hadamard products over all modes except s
            mask = (torch.arange(d, device=dev) != s)[:, None, None]
            Gm = torch.prod(torch.where(mask, GB, ones_r), dim=0)
            Cm = torch.prod(torch.where(mask, C, ones_c), dim=0)
            # normal equations: F_s diag(w) Cm = B_s diag(lam) Gm
            M = F[s] @ (w[:, None] * Cm)                                 # (n, r)
            Bs_l = torch.linalg.solve(Gm + ridge * eye, M.T).T           # B_s diag(lam)
            lam = torch.linalg.vector_norm(Bs_l, dim=0)
            B[s] = Bs_l / torch.where(lam > 0, lam, 1.0)[None, :]
    return lam, B


def cp_round(x: CPTensor, rank: int, iters: int = 10, ridge: float = 1e-10) -> CPTensor:
    """Best-effort rank reduction of a CP tensor by ALS fitting: minimizes
    ‖y − x‖ over rank-`rank` CP tensors y, each mode update an r×r SPD solve
    assembled from Hadamard products of the Gram matrices (O(d·n·T·r + d·r³)
    per sweep, nothing materialized). Starts from the `rank` largest-weight
    terms.

    ridge: Tikhonov shift for near-collinear factor columns (relative to the
    column-normalized Grams; the start routinely holds collinear columns, so
    keep it nonzero).
    """
    if rank >= x.rank:
        return x
    lam, B = _cp_round_als(x.weights, x.factors, rank, iters, ridge)
    return CPTensor(lam, B)


def kron_matvec_dense(op: KroneckerSumOperator, v: np.ndarray) -> np.ndarray:
    """Dense oracle: apply the full Kronecker-sum operator to a flat vector."""
    A = bands_to_dense(op)
    d, n, _ = A.shape
    out = np.zeros_like(v)
    x = v.reshape((n,) * d)
    for s in range(d):
        out += np.moveaxis(np.tensordot(A[s], x, axes=([1], [s])), 0, s).reshape(-1)
    return out


def kron_residual_dense(op: KroneckerSumOperator, x: CPTensor, b) -> float:
    """True relative residual ‖Ax − b‖/‖b‖ via full materialization (oracle)."""
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    bfull = np.array([1.0])
    for s in range(b.shape[0]):
        bfull = np.kron(bfull, b[s])
    r = kron_matvec_dense(op, cp_full(x)) - bfull
    return float(np.linalg.norm(r) / np.linalg.norm(bfull))
