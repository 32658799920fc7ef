"""Krylov steps on a mode-sharded basis. The JAX package has no such module:
GSPMD partitions its ``ops/orth.py`` steps. Here the partition is written out.

Each shard keeps its slab of the basis, ``(K, d_f, n_local)`` on its device;
H, b̃ and β are replicated on the lead device. Every n-sized dot is a partial
sum on its shard; the partials go to the lead device and are summed there in
shard order (the psum of the JAX package's collectives), and what the shards
need of the result goes back to them (``scatter``). The steps follow
``ops/orth.py`` line by line and take its helpers for the per-shard sweeps
and for every scalar rule (breakdown, restart, drift probe, the reorth
modes); only the sums over n are split, so a sharded solve agrees with the
unsharded one to rounding.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..ops.orth import (_REORTH, _TINY, KrylovState, _acc_dtype, _auto_threshold, _breakdown, _drift_probe,
                        _project_coeffs, _reorth_mode, _restart_direction, _restart_ok, _sqrt_rn, _subtract_span,
                        bdot)
from .halo import spmv_sharded
from .sharding import ShardedOperator

__all__ = ["psum", "scatter", "init_state", "lanczos_step", "arnoldi_step", "step_fn"]


def psum(sop: ShardedOperator, partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard partial sums (d_f, …) → (d, …) on the lead device: the mode
    shards of each factor group summed in shard order, the groups stacked in
    factor order."""
    P, lead = sop.n_mode, sop.device
    rows = []
    for g in range(len(partials) // P):
        acc = partials[g * P].to(lead)
        for x in partials[g * P + 1:(g + 1) * P]:
            acc = acc + x.to(lead)
        rows.append(acc)
    return rows[0] if len(rows) == 1 else torch.cat(rows)


def scatter(sop: ShardedOperator, t: torch.Tensor) -> List[torch.Tensor]:
    """A (d, …) tensor on the lead device → each shard's factor rows on its
    device (a view where the device is the lead's)."""
    return [t[sh.factors[0]:sh.factors[1]].to(sh.device) for sh in sop.shards]


def _project(sop, V, u, k, proj_dtype) -> torch.Tensor:
    """w = V[:k]ᵀ u per factor, (d, k) on the lead device."""
    return psum(sop, [_project_coeffs(Vi, ui, k, proj_dtype) for Vi, ui in zip(V, u)])


def _subtract(sop, V, u, w, k) -> List[torch.Tensor]:
    return [_subtract_span(Vi, ui, wi, k) for Vi, ui, wi in zip(V, u, scatter(sop, w))]


def _dot(sop, a, b) -> torch.Tensor:
    return psum(sop, [bdot(x, y) for x, y in zip(a, b)])


def init_state(sop: ShardedOperator, bs: Sequence[torch.Tensor], kmax: int, proj_dtype,
               basis_dtype=None) -> Tuple[KrylovState, torch.Tensor]:
    """Normalize b per factor into V[0] on every shard; returns (state,
    b_norms (d,)). state.V is the list of per-shard slabs (K, d_f, nl)."""
    K = kmax + 1
    dtype = basis_dtype if basis_dtype is not None else sop.dtype
    acc = _acc_dtype(dtype, proj_dtype)
    bs = [b.to(acc) for b in bs]
    b_norms = _sqrt_rn(_dot(sop, bs, bs)).to(proj_dtype)
    v0 = [b / nrm[:, None] for b, nrm in zip(bs, scatter(sop, b_norms.to(acc)))]
    V = []
    for b, v in zip(bs, v0):
        Vi = torch.zeros((K,) + tuple(b.shape), dtype=dtype, device=b.device)
        Vi[0] = v.to(dtype)
        V.append(Vi)
    lead = sop.device
    H = torch.zeros((sop.d, K, K), dtype=proj_dtype, device=lead)
    btil = torch.zeros((sop.d, K), dtype=proj_dtype, device=lead)
    btil[:, 0] = _dot(sop, v0, bs).to(proj_dtype)
    beta = torch.zeros((sop.d,), dtype=proj_dtype, device=lead)
    return KrylovState(V, H, btil, beta), b_norms


def _replace_lucky(sop, V, v_new, lucky, k, proj_dtype):
    """ops/orth.py:_replace_lucky on the shards: the restart direction at
    each shard's global columns and factors, so a restart gives the
    unsharded run's vector."""
    cdt = _acc_dtype(V[0].dtype, proj_dtype)
    vr = [_restart_direction(sh.cols, sh.factors, k, cdt, sh.device) for sh in sop.shards]
    nrm0 = torch.sqrt(psum(sop, [torch.sum(x.to(proj_dtype) ** 2, dim=1) for x in vr]))
    for _ in range(2):
        vr = _subtract(sop, V, vr, _project(sop, V, vr, k, proj_dtype), k)
    ok, den = _restart_ok(torch.sqrt(psum(sop, [torch.sum(x.to(proj_dtype) ** 2, dim=1) for x in vr])), nrm0)
    out = []
    for x, vn, ok_i, den_i, lk in zip(vr, v_new, scatter(sop, ok), scatter(sop, den), scatter(sop, lucky)):
        x = torch.where(ok_i[:, None], x / den_i.to(x.dtype)[:, None], 0.0)
        out.append(torch.where(lk[:, None], x.to(vn.dtype), vn))
    return out


def lanczos_step(sop: ShardedOperator, state: KrylovState, bs: Sequence[torch.Tensor], k: int, *, reorth,
                 proj_dtype, reorth_tol: float = 0.0):
    """ops/orth.py:lanczos_step (unfused) on the shards: basis vector k for all
    factors, the state updated in place. Returns (state, loss estimate)."""
    V, H, btil, beta = state
    acc = _acc_dtype(V[0].dtype, proj_dtype)
    mode = _reorth_mode(reorth)
    v_prev = [Vi[k - 1].to(acc) for Vi in V]
    v_pprev = [Vi[max(k - 2, 0)].to(acc) for Vi in V]
    b = [x.to(acc) for x in bs]

    u = spmv_sharded(sop, v_prev)
    # beta is zero at k == 1, so v_pprev = V[0] contributes nothing
    u = [ui - bt[:, None] * vpp for ui, bt, vpp in zip(u, scatter(sop, beta.to(acc)), v_pprev)]
    alpha = _dot(sop, u, v_prev).to(proj_dtype)
    u = [ui - a[:, None] * vp for ui, a, vp in zip(u, scatter(sop, alpha.to(acc)), v_prev)]
    loss = None
    if mode == "always":
        w = _project(sop, V, u, k, proj_dtype)
        u = _subtract(sop, V, u, w, k)
        loss = torch.linalg.vector_norm(w)
    beta_sq = _dot(sop, u, u).to(proj_dtype)
    ub = _dot(sop, u, b).to(proj_dtype)

    probe = _drift_probe(ub, btil[:, 0], beta_sq)
    if loss is None:
        loss = probe
    if mode == "auto":
        if bool(probe > _auto_threshold(reorth_tol, acc)):
            u = _subtract(sop, V, u, _project(sop, V, u, k, proj_dtype), k)
            beta_sq = _dot(sop, u, u).to(proj_dtype)
            ub = _dot(sop, u, b).to(proj_dtype)

    beta_new = _sqrt_rn(torch.clamp(beta_sq, min=0.0))
    beta_new, lucky, safe = _breakdown(beta_new, torch.abs(alpha) + beta + _TINY, acc)
    v_new = [ui / sf.to(acc)[:, None] for ui, sf in zip(u, scatter(sop, safe))]
    bt_new = ub / safe
    if bool(lucky.any()):
        v_new = _replace_lucky(sop, V, v_new, lucky, k, proj_dtype)
        bt_new = _dot(sop, v_new, b).to(proj_dtype)

    for Vi, vi in zip(V, v_new):
        Vi[k] = vi.to(Vi.dtype)
    H[:, k - 1, k - 1] = alpha
    H[:, k, k - 1] = beta_new
    H[:, k - 1, k] = beta_new
    btil[:, k] = bt_new
    return KrylovState(V, H, btil, beta_new), loss


def arnoldi_step(sop: ShardedOperator, state: KrylovState, bs: Sequence[torch.Tensor], k: int, *, proj_dtype):
    """ops/orth.py:arnoldi_step (CGS2) on the shards. Returns (state, the
    norm of the second sweep's coefficients)."""
    V, H, btil, _ = state
    acc = _acc_dtype(V[0].dtype, proj_dtype)
    u = spmv_sharded(sop, [Vi[k - 1].to(acc) for Vi in V])
    w1 = _project(sop, V, u, k, proj_dtype)
    u = _subtract(sop, V, u, w1, k)
    w2 = _project(sop, V, u, k, proj_dtype)
    u = _subtract(sop, V, u, w2, k)
    h = w1 + w2

    h_new = _sqrt_rn(_dot(sop, u, u).to(proj_dtype))
    h_new, lucky, safe = _breakdown(h_new, torch.sum(torch.abs(h), dim=1) + _TINY, acc)
    v_new = [ui / sf.to(acc)[:, None] for ui, sf in zip(u, scatter(sop, safe))]
    if bool(lucky.any()):
        v_new = _replace_lucky(sop, V, v_new, lucky, k, proj_dtype)

    for Vi, vi in zip(V, v_new):
        Vi[k] = vi.to(Vi.dtype)
    H[:, :k, k - 1] = h
    H[:, k, k - 1] = h_new
    btil[:, k] = _dot(sop, v_new, [x.to(acc) for x in bs]).to(proj_dtype)
    return KrylovState(V, H, btil, h_new), torch.linalg.vector_norm(w2)


def step_fn(config):
    """The sharded Krylov step of config.orth: (sop, state, bs, k) → (state, loss)."""
    pdt = config.proj_dtype
    if config.orth == "arnoldi":
        return lambda sop, st, bs, k: arnoldi_step(sop, st, bs, k, proj_dtype=pdt)
    reorth = _REORTH[config.orth]
    return lambda sop, st, bs, k: lanczos_step(sop, st, bs, k, reorth=reorth, proj_dtype=pdt,
                                               reorth_tol=config.reorth_tol)
