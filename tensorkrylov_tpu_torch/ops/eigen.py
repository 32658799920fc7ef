"""Spectral estimation for the projected Kronecker-sum operator: counterpart
of ``tensorkrylov_tpu/ops/eigen.py``.

``masked_eigh`` is the dense eigh (``torch.linalg.eigh``).
``masked_eigh_tridiag_mixed`` is the tridiagonal eigensolver that the Lanczos
path runs on the card: the CUDA kernel ``csrc/tridiag_eigh.cu`` (Sturm
multisection, inverse iteration, cluster Gram–Schmidt, one thread-block
cluster per factor) for a CUDA tensor, its
plain version ``masked_eigh_tridiag_reference`` for a CPU tensor, then two
Newton–Schulz steps. The JAX package seeds its solver with an f32 dense eigh
because f64 eigh is emulated on the TPU; the card has native f64, so the port
multisects instead of seeding.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ..types import KroneckerSumOperator
from ..utils.profiling import host_read
from . import _build
from ._cluster import cluster_plan, device_index, max_active_clusters, sm_count
from .orth import _sqrt_rn

__all__ = [
    "dense_minor_window",
    "masked_eigh",
    "masked_eigh_tridiag_mixed",
    "masked_eigh_tridiag_reference",
    "tridiag_eigh",
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


# The tridiagonal eigensolver's rules, shared by the kernel (passed at launch)
# and its plain version.
TRIDIAG_BISECT_ITERS = 64     # halvings the multisection rounds cover (~54 reach adjacent floats)
TRIDIAG_CLUSTER_RTOL = 1e-6   # consecutive eigenvalues this close, relative to ‖T‖, form a cluster
# Sturm probe lanes of a call, d·k·P at most: ~12 warps an SM over the 80 SMs
# that d=10 clusters of G=8 take on the H100, where a probe still runs at its
# division chain's latency; at twice that the f64 pipe falls behind (d=10,
# K=513, k=384 at G=8: P=8 took 1.246 ms, P=16 1.418).
TRIDIAG_LANES = 1 << 15
TRIDIAG_MAX_P = 32            # lanes per eigenvalue: at most a warp


def tridiag_lanes(d: int, k: int) -> int:
    """P, the lanes of each eigenvalue's multisection (P − 1 Sturm probes a
    round, log₂P bits): the largest power of two up to TRIDIAG_MAX_P with
    d·k·P ≤ TRIDIAG_LANES, and at least 2 (bisection). More lanes pay where
    k is small and the chain's latency sets the pace; fewer where d·k·P would
    oversubscribe the f64 pipes."""
    P = TRIDIAG_MAX_P
    while P > 2 and d * k * P > TRIDIAG_LANES:
        P //= 2
    return P


def tridiag_rounds(P: int) -> int:
    """The most multisection rounds of P lanes: ⌈TRIDIAG_BISECT_ITERS / log₂P⌉."""
    return -(-TRIDIAG_BISECT_ITERS // (P.bit_length() - 1))


def _tridiag_rules(dtype, refine_vectors: bool, d: int, k: int, lanes: Optional[int] = None):
    """(lanes P per eigenvalue, most multisection rounds, inverse-iteration
    solves, eps, the Sturm count's zero guard, cluster gap relative to ‖T‖):
    P from tridiag_lanes(d, k) unless `lanes` forces it; two solves with
    refine_vectors (an f64 basis), one without."""
    P = tridiag_lanes(d, k) if lanes is None else int(lanes)
    if P < 2 or P > TRIDIAG_MAX_P or P & (P - 1):
        raise ValueError(f"lanes per eigenvalue must be a power of two in 2..{TRIDIAG_MAX_P}, got {P}")
    fi = torch.finfo(dtype)
    return P, tridiag_rounds(P), 2 if refine_vectors else 1, fi.eps, fi.tiny * 1e8, TRIDIAG_CLUSTER_RTOL


def _start_vectors(k: int, dtype, device) -> torch.Tensor:
    """(k rows, k columns) start vectors of the inverse iteration, one column
    per eigenvalue: an integer hash of (row, column), its top 24 bits scaled
    into [-0.5, 0.5), exact in f32 and f64 (the kernel's start_value)."""
    i = torch.arange(1, k + 1, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(1, k + 1, dtype=torch.int64, device=device)[None, :]
    h = (i * 2654435761 + j * 2246822519) & 0xFFFFFFFF
    h = h ^ (h >> 15)
    h = (h * 739982445) & 0xFFFFFFFF
    h = h ^ (h >> 12)
    return ((h >> 8).to(torch.float64) / 16777216.0 - 0.5).to(dtype)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's fixed halving tree (entry
    i + half added to entry i, half = ⌈len/2⌉, until one is left); keeps the
    axis, length 1."""
    x = x.clone()
    n = x.shape[-1]
    while n > 1:
        half = (n + 1) // 2
        x[..., :n - half] = x[..., :n - half] + x[..., half:n]
        n = half
    return x[..., :1]


def _orthonormalize_clusters(X: torch.Tensor, joins: torch.Tensor) -> None:
    """Modified Gram–Schmidt within each cluster of X's columns (d, k, k), in
    index order, as the kernel's first member of a cluster runs it: member m
    loses its component on each earlier member p (a tree-summed dot), then is
    normalised. joins[s, j]: column j is in column j−1's cluster."""
    d, k, _ = X.shape
    jn = joins.cpu().tolist()
    for s in range(d):
        for m in range(1, k):
            if not jn[s][m]:
                continue
            a = m - 1
            while jn[s][a]:
                a -= 1
            col = X[s, :, m]
            for p in range(a, m):
                col = col - _tree_sum(col * X[s, :, p]) * X[s, :, p]
            nrm = _sqrt_rn(_tree_sum(col * col))
            X[s, :, m] = col / torch.where(nrm > 0, nrm, torch.ones_like(nrm))


def _cluster_sizes(joins: torch.Tensor) -> list:
    """The sizes of the clusters of two or more members, over all factors."""
    sizes = []
    for row in joins.cpu().tolist():
        run = 1
        for joined in row[1:] + [False]:
            if joined:
                run += 1
                continue
            if run > 1:
                sizes.append(run)
            run = 1
    return sizes


def _sturm_counts(dg: torch.Tensor, e2: torch.Tensor, x: torch.Tensor, tiny: torch.Tensor) -> torch.Tensor:
    """The kernel's Sturm count at every probe x (d, ...) of the active
    tridiagonals dg, e2 (d, k) (e2[:, 0] = 0): q_i = (d_i − x) − e²_i/q_{i−1},
    |q| < tiny set to −tiny, counting negative q_i."""
    shape = (dg.shape[0],) + (1,) * (x.dim() - 1)
    q = torch.ones_like(x)
    count = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for i in range(dg.shape[1]):
        q = (dg[:, i].view(shape) - x) - e2[:, i].view(shape) / q
        q = torch.where(q.abs() < tiny, -tiny, q)
        count += q < 0
    return count


def _multisection_select(lo: torch.Tensor, hi: torch.Tensor, x: torch.Tensor, counts: torch.Tensor,
                         j: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One multisection round's new bracket of eigenvalue j: the first probe
    whose count exceeds j is the new hi and the probe before it (lo before
    the first) the new lo; where no count exceeds j, the last probe is the
    new lo. lo, hi, j (...); x, counts (..., P − 1), the probes ascending.

    A floating-point Sturm count need not be monotone in x, so a count of
    the probes at or below j could pick a lo whose count exceeds j; this
    rule keeps count(lo) ≤ j < count(hi) whatever the counts."""
    above = counts > j[..., None]
    found = above.any(-1)
    f = above.to(torch.int32).argmax(-1, keepdim=True)   # the first probe above j
    x_f = x.gather(-1, f).squeeze(-1)
    x_before = torch.where(f > 0, x.gather(-1, (f - 1).clamp(min=0)), lo[..., None]).squeeze(-1)
    return torch.where(found, x_before, x[..., -1]), torch.where(found, x_f, hi)


def masked_eigh_tridiag_reference(H: torch.Tensor, k, refine_vectors: bool = True, stats: Optional[dict] = None,
                                  lanes: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``csrc/tridiag_eigh.cu`` kernel: the eigenpairs of
    the active k×k blocks of the symmetric tridiagonal H (d, K, K), before
    Newton–Schulz. Every operation is rounded on its own, in the kernel's
    order, so the two agree bit for bit.

    Per factor: the Gershgorin bracket of the active rows, widened by
    2·eps·‖T‖ (‖T‖ its larger end in magnitude); per eigenvalue j, at most
    tridiag_rounds(P) multisection rounds of P lanes (P = tridiag_lanes(d, k)
    unless `lanes` forces it): probes x_ℓ = lo + (hi − lo)·(ℓ/P), ℓ = 1..P−1,
    each a Sturm count over the k active rows, then ``_multisection_select``'s
    bracket; a bracket with no probe strictly inside stops, and λ_j is
    0.5·(lo + hi). Then one or two (refine_vectors) inverse-iteration solves
    of the JAX package's guarded Thomas algorithm, pivots at least piv =
    eps·‖T‖ in magnitude and the right side scaled by piv (x then stays near
    unit size at any scale of T), from distinct hashed start vectors, each
    normalised and followed by modified Gram–Schmidt within each cluster
    (consecutive eigenvalues within TRIDIAG_CLUSTER_RTOL·‖T‖).

    Returns w (d, K), ascending on the active block, the padded slots holding
    w[:, :1], and Q (d, K, K), the active eigenvectors in columns 0..k−1 and
    the identity's columns on the padded block. A `stats` dict receives what
    this input needed: `halvings`, the bisection-equivalent work (log₂P per
    live round, summed over eigenvalues), `probes`, the Sturm sweeps run
    ((P − 1) per live round), inverse-iteration `solves`, and the cluster
    Gram–Schmidt's pairs and members.
    """
    d, K, _ = H.shape
    k = int(k)
    dtype, dev = H.dtype, H.device
    P, rounds, steps, eps_, tiny_, rtol_ = _tridiag_rules(dtype, refine_vectors, d, k, lanes)
    eps, tiny, rtol = (torch.tensor(v, dtype=dtype, device=dev) for v in (eps_, tiny_, rtol_))
    idx = torch.arange(k, device=dev)
    dg = H[:, idx, idx]
    e = torch.zeros((d, k + 1), dtype=dtype, device=dev)   # e[:, i] couples rows i−1 and i
    e[:, 1:k] = H[:, idx[1:], idx[1:] - 1]
    e2 = e[:, :k] * e[:, :k]

    r = e[:, :k].abs() + e[:, 1:].abs()
    glo = (dg - r).amin(dim=1)
    ghi = (dg + r).amax(dim=1)
    gnorm = torch.maximum(glo.abs(), ghi.abs())
    pad = (eps + eps) * gnorm
    piv = torch.maximum(eps * gnorm, tiny)[:, None]
    tau = rtol * gnorm

    # multisection, every (factor, eigenvalue, probe) at once
    lo = (glo - pad)[:, None].expand(d, k).clone()
    hi = (ghi + pad)[:, None].expand(d, k).clone()
    target = idx.expand(d, k)
    frac = torch.arange(1, P, dtype=dtype, device=dev) / P   # ℓ/P, exact
    live_rounds = 0
    for _ in range(rounds):
        x = lo[..., None] + (hi - lo)[..., None] * frac
        live = ((x > lo[..., None]) & (x < hi[..., None])).any(-1)
        n_live = int(live.sum())
        if not n_live:
            break
        live_rounds += n_live
        new_lo, new_hi = _multisection_select(lo, hi, x, _sturm_counts(dg, e2, x, tiny), target)
        lo = torch.where(live, new_lo, lo)
        hi = torch.where(live, new_hi, hi)
    lam = 0.5 * (lo + hi)
    joins = torch.zeros((d, k), dtype=torch.bool, device=dev)
    joins[:, 1:] = (lam[:, 1:] - lam[:, :-1]) <= tau[:, None]

    # inverse iteration: X (d, rows, eigenvalues)
    X = _start_vectors(k, dtype, dev).expand(d, k, k)
    for _ in range(steps):
        cp = torch.zeros((d, k), dtype=dtype, device=dev)
        dp = torch.zeros_like(cp)
        cps, dps = [], []
        for i in range(k):
            a = e[:, i, None]
            den = (dg[:, i, None] - lam) - a * cp
            den = torch.where(den.abs() < piv, torch.where(den < 0, -piv, piv), den)
            num = X[:, i] * piv - a * dp
            cp = e[:, i + 1, None] / den
            dp = num / den
            cps.append(cp)
            dps.append(dp)
        x = torch.zeros_like(cp)
        nrm2 = torch.zeros_like(cp)
        rows = [None] * k
        for i in reversed(range(k)):
            x = dps[i] - cps[i] * x
            rows[i] = x
            nrm2 = nrm2 + x * x
        nrm = _sqrt_rn(nrm2)
        X = torch.stack(rows, dim=1) / torch.where(nrm > 0, nrm, torch.ones_like(nrm))[:, None, :]
        _orthonormalize_clusters(X, joins)
    if stats is not None:
        # a cluster of c members makes c − 1 renormalisations and c(c − 1)/2 pairs, per solve
        sizes = _cluster_sizes(joins)
        stats.update(lanes=P, rounds=rounds, halvings=(P.bit_length() - 1) * live_rounds,
                     probes=(P - 1) * live_rounds, solves=steps,
                     mgs_members=steps * sum(c - 1 for c in sizes),
                     mgs_pairs=steps * sum(c * (c - 1) // 2 for c in sizes))

    w = torch.cat([lam, lam[:, :1].expand(d, K - k)], dim=1)
    Q = torch.eye(K, dtype=dtype, device=dev).repeat(d, 1, 1)
    Q[:, :k, :k] = X
    return w, Q


# probe lanes per cluster_plan chunk (4 warps): a factor runs ceil(k·P / 128) chunks
TRIDIAG_CHUNK_LANES = 128


def tridiag_cluster(d: int, k: int, P: int, dtype=torch.float64, device=None) -> int:
    """G, the blocks of each factor's thread-block cluster: ``cluster_plan``
    over the ⌈k·P / 128⌉ chunks of probe lanes a factor runs, with the
    clusters that fit counted at one block an SM (the kernel's occupancy at
    this (k, P, G), at most SMs / G): two blocks of probes on one SM share
    its f64 pipe (at d=10, K=513, k=384, P=16 on the H100, G=16 on 160
    blocks took 1.68 ms and G=8 on 80 blocks 1.42). G leaves the result
    unchanged."""
    return _tridiag_cluster(d, k, P, torch.empty((), dtype=dtype).element_size(), device_index(device))


@functools.lru_cache(maxsize=None)
def _tridiag_cluster(d: int, k: int, P: int, itemsize: int, index: int) -> int:
    sms = sm_count(index)
    return cluster_plan(d, -(-k * P // TRIDIAG_CHUNK_LANES), sms,
                        lambda G: min(sms // G, max_active_clusters("tk_tridiag_eigh_max_clusters", index, k, P,
                                                                    G, itemsize)))


def _tridiag_eigh_cuda(H: torch.Tensor, k: int, refine_vectors: bool, lanes: Optional[int] = None,
                       cluster: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch: P lanes per eigenvalue (tridiag_lanes unless
    `lanes` forces it) and G blocks per factor (tridiag_cluster unless
    `cluster` forces it, 1..16)."""
    if H.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tridiag_eigh kernel takes f32 or f64 H, got {H.dtype}")
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"H must be (d, K, K), got {tuple(H.shape)}")
    d, K, _ = H.shape
    if not 1 <= k <= K:
        raise ValueError(f"the active size k={k} must lie in 1..K={K}")
    P, rounds, steps, eps, tiny, rtol = _tridiag_rules(H.dtype, refine_vectors, d, k, lanes)
    G = tridiag_cluster(d, k, P, H.dtype, H.device) if cluster is None else int(cluster)
    H = H.contiguous()
    w = torch.empty((d, K), dtype=H.dtype, device=H.device)
    Q = torch.empty((d, K, K), dtype=H.dtype, device=H.device)
    scratch = torch.empty_like(Q)
    lib = _build.kernels()
    fn = lib.tk_tridiag_eigh_f64 if H.dtype == torch.float64 else lib.tk_tridiag_eigh_f32
    err = fn(H.data_ptr(), w.data_ptr(), Q.data_ptr(), scratch.data_ptr(), d, K, k, P, rounds, steps, G,
             eps, tiny, rtol, _build.stream_of(H))
    _build.check(err, "tridiag_eigh")
    _build.launches["tridiag_eigh"] += 1
    return w, Q


def tridiag_eigh(H: torch.Tensor, k, refine_vectors: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tridiagonal eigenpairs before Newton–Schulz (masked_eigh_tridiag_reference's
    contract): the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor; any other device raises."""
    if H.device.type == "cuda":
        return _tridiag_eigh_cuda(H, host_read(k, int), refine_vectors)
    if H.device.type == "cpu":
        return masked_eigh_tridiag_reference(H, k, refine_vectors)
    raise ValueError(f"tridiag_eigh runs on cuda or cpu tensors, got {H.device}")


def masked_eigh_tridiag_mixed(H: torch.Tensor, k, refine_vectors: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """eigh of the active k×k blocks of symmetric tridiagonal matrices stored
    padded in H (d, K, K): ``tridiag_eigh``, then two Newton–Schulz steps
    X ← 1.5 X − 0.5 X (XᵀX) (f64 GEMMs, as in the JAX package) on the active
    block X = Q[:, :k, :k], each one ``bmm`` and one ``baddbmm``. The padded
    product gives the identity columns and zero blocks back exactly, so this
    is the JAX package's step up to the GEMMs' rounding; Q, this call's own
    output, is updated in place.

    refine_vectors (an f64 basis) runs two inverse-iteration solves, one
    without. Returns w (d, K), ascending active eigenvalues with the padded
    slots holding the active minimum, and Q (d, K, K) orthonormal, the active
    eigenvectors in columns 0..k−1 and identity columns on the padded block.
    This is not masked_eigh's layout (its padded eigenvalues are sorted among
    the active ones); cp_solve_sym takes both, b̃ being zero on the pad.
    """
    k = host_read(k, int)
    w, Q = tridiag_eigh(H, k, refine_vectors)
    X = Q[:, :k, :k]
    for _ in range(2):
        X = torch.baddbmm(X, X, X.transpose(1, 2) @ X, beta=1.5, alpha=-0.5)
    Q[:, :k, :k] = X
    return w, Q
