"""Batched Lanczos steps: counterpart of ``tensorkrylov_tpu/ops/orth.py``.

The d factors are a leading batch axis: one step advances all d recurrences.
The basis keeps the JAX package's K-leading layout ``V (K, d, n)``, so each
step's basis write is one contiguous slab and ``V[:k]`` is the active prefix.

Each step is written once, over shard pieces (``parallel/krylov.py``): the
operator is a ``KroneckerSumOperator`` (one piece: V, b are tensors) or a
``ShardedOperator`` (V, b are lists of per-shard slabs ``(K, d_f, n_local)``
and ``(d_f, n_local)``); every n-sized dot is a per-piece partial summed by
``psum``, the SpMV is ``spmv_pieces``, and H, b̃, β live on the lead device.
The one-piece step runs the unsharded operations unchanged, bit for bit.

Where the JAX package keeps every array at its padded size and masks, the
port slices the active prefix ``V[:k]``, and it updates the state in place:
``lanczos_step`` writes column k of V, entries of H and b̃, and returns the
same tensors. The sweeps over the prefix are one strided batched product in
the compute dtype; the TPU's column chunking and emulated-f64 dot are not
needed on the card. ``deflation_project`` keeps a deflated recurrence in the
complement of the deflated eigenvectors U (``deflate.py``): two GEMMs over U.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..parallel.krylov import like, piece_ranges, pieces, psum, scatter, spmv_pieces
from ..types import KroneckerSumOperator
from .fused_lanczos import fixed_order_sum, fused_lanczos_core

__all__ = ["KrylovState", "init_state", "lanczos_step", "arnoldi_step", "orthogonality_loss", "lanczos_algorithm",
           "arnoldi_algorithm", "deflation_project"]


class KrylovState(NamedTuple):
    """Krylov decomposition state for all d factors (K = kmax + 1).

    V: (K, d, n) orthonormal bases, Krylov index leading.
    H: (d, K, K) projected matrices (proj dtype): H[s, i, j] = v_i^T A v_j.
    btil: (d, K) compressed RHS entries <v_j, b_s>.
    beta: (d,) last subdiagonal (the recurrence carry).
    """

    V: torch.Tensor
    H: torch.Tensor
    btil: torch.Tensor
    beta: torch.Tensor


# config.orth of a Lanczos step → its reorth argument
_REORTH = {"lanczos": False, "lanczos_reorth": True, "lanczos_reorth_auto": "auto"}
_TINY = 1e-300


def _acc_dtype(basis_dtype, proj_dtype):
    """Compute dtype of length-n work: the projected dtype when the basis is
    f64, else f32 (a narrower basis is promoted to f32 for arithmetic)."""
    return proj_dtype if basis_dtype == torch.float64 else torch.float32


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded √x. CUDA's sqrt is; torch's CPU sqrt is not always
    (about 1 value in 100 is 1 ulp off), and a recurrence that is not
    reorthogonalized amplifies that, so CPU tensors take numpy's IEEE sqrt."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched per-factor dot ⟨a_s, b_s⟩ over the last axis."""
    return torch.einsum("...n,...n->...", a, b)


def unit_start(op, bs: List[torch.Tensor], proj_dtype) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """v_0 = b_s/‖b_s‖ over pieces bs (in the compute dtype): (v_0's pieces,
    ‖b_s‖ (d,), ⟨v_0, b_s⟩ (d,)), the sums in the fused kernel's fixed order.
    A recurrence that is not reorthogonalized amplifies their rounding, so
    every solve that starts a Lanczos recurrence (init_state, the two-pass
    solve's two passes) starts here, from the same bits on every device."""
    b_norms = _sqrt_rn(psum(op, [fixed_order_sum(x * x) for x in bs])).to(proj_dtype)
    v0 = [x / nrm[:, None] for x, nrm in zip(bs, scatter(op, b_norms.to(bs[0].dtype)))]
    return v0, b_norms, psum(op, [fixed_order_sum(v * x) for v, x in zip(v0, bs)]).to(proj_dtype)


def init_state(op, b, kmax: int, proj_dtype, basis_dtype=None) -> Tuple[KrylovState, torch.Tensor]:
    """Normalize b per factor into V[0]; returns (state, b_norms (d,)).
    op and b: a KroneckerSumOperator and (d, n), or a ShardedOperator and
    its pieces (state.V is then the list of per-shard slabs)."""
    bs = pieces(b)
    K = kmax + 1
    dtype = basis_dtype if basis_dtype is not None else op.dtype
    acc = _acc_dtype(dtype, proj_dtype)
    v0, b_norms, bt0 = unit_start(op, [x.to(acc) for x in bs], proj_dtype)
    V = []
    for x, v in zip(bs, v0):
        Vi = torch.zeros((K,) + tuple(x.shape), dtype=dtype, device=x.device)
        Vi[0] = v.to(dtype)
        V.append(Vi)
    lead = b_norms.device
    H = torch.zeros((op.d, K, K), dtype=proj_dtype, device=lead)
    btil = torch.zeros((op.d, K), dtype=proj_dtype, device=lead)
    btil[:, 0] = bt0
    beta = torch.zeros((op.d,), dtype=proj_dtype, device=lead)
    return KrylovState(like(b, V), H, btil, beta), b_norms


def _project_coeffs(V, u, k, proj_dtype):
    """w = V[:k]^T u per factor: (d, k)."""
    acc = _acc_dtype(V.dtype, proj_dtype)
    Vk = V[:k].to(acc).transpose(0, 1)                         # (d, k, n), strided
    return torch.bmm(Vk, u.to(acc)[:, :, None])[:, :, 0].to(proj_dtype)


def _subtract_span(V, u, w, k):
    """u − Σ_{j<k} w_j V[j], accumulated in u's (compute) dtype."""
    Vk = V[:k].to(u.dtype).permute(1, 2, 0)                    # (d, n, k), strided
    return u - torch.bmm(Vk, w.to(u.dtype)[:, :, None])[:, :, 0]


def _project(op, V, u, k, proj_dtype) -> torch.Tensor:
    """w = V[:k]ᵀ u per factor over pieces, (d, k) on the lead device."""
    return psum(op, [_project_coeffs(Vi, ui, k, proj_dtype) for Vi, ui in zip(V, u)])


def _subtract(op, V, u, w, k) -> List[torch.Tensor]:
    """u − Σ_{j<k} w_j V[j] on every piece."""
    return [_subtract_span(Vi, ui, wi, k) for Vi, ui, wi in zip(V, u, scatter(op, w))]


def _dot(op, a, b) -> torch.Tensor:
    """⟨a_s, b_s⟩ per factor over pieces, (d,) on the lead device."""
    return psum(op, [bdot(x, y) for x, y in zip(a, b)])


def _reorth_mode(reorth) -> str:
    return "auto" if reorth == "auto" else ("always" if reorth else "plain")


def _restart_direction(cols: Tuple[int, int], factors: Tuple[int, int], k: int, dtype, device) -> torch.Tensor:
    """cos((i + 0.7)(1 + 0.01 s) + 0.37 k) at columns i ∈ [c0, c1) and factors
    s ∈ [s0, s1): the lucky-breakdown restart's direction, the same at a
    column whether the basis is whole or split over shards."""
    i = torch.arange(*cols, dtype=dtype, device=device)
    s = torch.arange(*factors, dtype=dtype, device=device)[:, None]
    return torch.cos((i[None, :] + 0.7) * (1.0 + 0.01 * s) + 0.37 * float(k))


def _restart_ok(nrm: torch.Tensor, nrm0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(whether the twice-orthogonalized restart direction kept more than
    2^-12 of its norm, the divisor that normalizes it)."""
    return nrm > 2.0**-12 * nrm0, torch.where(nrm > 0, nrm, 1.0)


def _breakdown(h_new: torch.Tensor, scale: torch.Tensor, dtype):
    """Lucky breakdown where the new vector's norm is below 256 eps·scale:
    (the norm, zero there; the mask; the divisor, one there)."""
    lucky = h_new < 256.0 * torch.finfo(dtype).eps * scale
    h_new = torch.where(lucky, 0.0, h_new)
    return h_new, lucky, torch.where(h_new > 0, h_new, 1.0)


def _drift_probe(ub: torch.Tensor, b_norm: torch.Tensor, beta_sq: torch.Tensor) -> torch.Tensor:
    """v_0-drift probe |⟨u, b⟩|/(β‖b_s‖) = |⟨v_k, v_0⟩| (b̃[:, 0] = ‖b_s‖)."""
    beta_pre = torch.sqrt(torch.clamp(beta_sq, min=_TINY))
    return torch.max(torch.abs(ub) / (b_norm * beta_pre + _TINY))


def _auto_threshold(reorth_tol: float, dtype) -> float:
    return reorth_tol if reorth_tol > 0.0 else math.sqrt(torch.finfo(dtype).eps)


def deflation_coeffs(u: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """c = U_sᵀ u_s per factor: (d, m). U is (1, n, m), shared by every
    factor (one GEMM over U whatever d is), or (d, n, m)."""
    U = U.to(u.dtype)
    if U.shape[0] == 1:
        return u @ U[0]
    return torch.bmm(u[:, None, :], U)[:, 0]


def deflation_subtract(u: torch.Tensor, U: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """u − U c per factor, with c from deflation_coeffs."""
    U = U.to(u.dtype)
    if U.shape[0] == 1:
        return u - c @ U[0].T
    return u - torch.bmm(c[:, None, :], U.transpose(1, 2))[:, 0]


def _deflate(op, u, U) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """deflation_project over pieces: c = psum(U_pieceᵀ u_piece), then
    u − U c on every piece. Returns (the pieces, c (d, m) on the lead)."""
    c = psum(op, [deflation_coeffs(ui, Ui) for ui, Ui in zip(u, U)])
    return [deflation_subtract(ui, Ui, ci) for ui, Ui, ci in zip(u, U, scatter(op, c))], c


def deflation_project(u: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """u − U (Uᵀ u) per factor, in u's dtype: the projection onto the
    complement of the deflated eigenvectors (two plain GEMMs; the JAX
    package's column chunking bounds the TPU's emulated-f64 temporaries and
    is not needed here)."""
    return deflation_subtract(u, U, deflation_coeffs(u, U))


def _replace_lucky(op, V, v_new, lucky, k, proj_dtype, deflate_U=None):
    """Lucky-breakdown restart: for factors whose new Krylov vector vanished
    (the space is A-invariant), continue with a fixed pseudo-random direction
    orthogonalized twice against the basis; an exhausted space gets a zero
    column (A·0 = 0 and ⟨·,0⟩ = 0 keep it inert). With deflate_U the
    direction is also projected into the U-complement, where the deflated
    recurrence lives. Over pieces, the direction is taken at each piece's
    columns and factors of the whole, so a restart gives the unsharded
    run's vector."""
    acc = _acc_dtype(V[0].dtype, proj_dtype)
    vr = [_restart_direction(cols, factors, k, acc, Vi.device) for (cols, factors), Vi in zip(piece_ranges(op, V), V)]
    nrm0 = torch.sqrt(psum(op, [torch.sum(x.to(proj_dtype) ** 2, dim=1) for x in vr]))
    for _ in range(2):
        if deflate_U is not None:
            vr, _ = _deflate(op, vr, pieces(deflate_U))
        vr = _subtract(op, V, vr, _project(op, V, vr, k, proj_dtype), k)
    ok, den = _restart_ok(torch.sqrt(psum(op, [torch.sum(x.to(proj_dtype) ** 2, dim=1) for x in vr])), nrm0)
    out = []
    for x, vn, ok_i, den_i, lk in zip(vr, v_new, scatter(op, ok), scatter(op, den), scatter(op, lucky)):
        x = torch.where(ok_i[:, None], x / den_i.to(x.dtype)[:, None], 0.0)
        out.append(torch.where(lk[:, None], x.to(vn.dtype), vn))
    return out


def lanczos_step(op, state: KrylovState, b, k: int, *, reorth, proj_dtype, fused: bool = False,
                 reorth_tol: float = 0.0, deflate_U=None):
    """One three-term-recurrence step producing basis vector k for all
    factors. Returns (state, orthogonality-loss estimate); the state's
    tensors are updated in place. op, state.V, b (and deflate_U) are one
    piece or a ShardedOperator's pieces (module docstring).

    reorth: False (plain) | True (always one extra classical Gram–Schmidt
    sweep over V[:k]) | 'auto' (the sweep runs when the drift probe
    |⟨v_k, v_0⟩| = |⟨u, b⟩|/(β‖b_s‖) exceeds reorth_tol, or √eps of the
    compute dtype when reorth_tol is 0).

    fused=True computes the recurrence core (SpMV, the α/β updates and the
    α, β², ⟨u, b⟩ sums) with ops.fused_lanczos in plain and auto modes; it
    runs on one piece only (the fused core has no psum).

    deflate_U: (1, n, m) or (d, n, m) deflated eigenvectors (per piece
    (1 | d_f, n_local, m)); u is projected into their complement after the α
    update (deflation_project), so that roundoff does not regrow the
    deflated modes. The fused core has no room for the projection between α
    and β², so fused=True with deflate_U raises (the JAX package quietly
    takes its unfused step there).
    """
    V, H, btil, beta = state
    Vs, bs = pieces(V), pieces(b)
    acc = _acc_dtype(Vs[0].dtype, proj_dtype)
    mode = _reorth_mode(reorth)
    if fused and deflate_U is not None:
        raise ValueError("lanczos_step: fused=True cannot take deflate_U (the fused core has no deflation "
                         "projection); use fused=False (ROADMAP.md Queue 1, recorded divergences)")
    if fused and len(Vs) > 1:
        raise ValueError("lanczos_step: fused=True runs on one piece (the fused core sums over the whole n); "
                         "a sharded step is unfused")
    v_prev = [Vi[k - 1].to(acc) for Vi in Vs]
    v_pprev = [Vi[max(k - 2, 0)].to(acc) for Vi in Vs]
    bs = [x.to(acc) for x in bs]

    loss = None
    if fused and mode != "always":
        u, alpha, beta_sq, ub = fused_lanczos_core(op, v_prev[0], v_pprev[0], beta.to(acc), bs[0])
        u = [u]
        alpha, beta_sq, ub = alpha.to(proj_dtype), beta_sq.to(proj_dtype), ub.to(proj_dtype)
    else:
        u = spmv_pieces(op, v_prev)
        # beta is zero at k == 1, so v_pprev = V[0] contributes nothing
        u = [ui - bt[:, None] * vpp for ui, bt, vpp in zip(u, scatter(op, beta.to(acc)), v_pprev)]
        alpha = _dot(op, u, v_prev).to(proj_dtype)
        u = [ui - a[:, None] * vp for ui, a, vp in zip(u, scatter(op, alpha.to(acc)), v_prev)]
        if deflate_U is not None:
            u, _ = _deflate(op, u, pieces(deflate_U))
        if mode == "always":
            w = _project(op, Vs, u, k, proj_dtype)
            u = _subtract(op, Vs, u, w, k)
            loss = torch.linalg.vector_norm(w)
        beta_sq = _dot(op, u, u).to(proj_dtype)
        ub = _dot(op, u, bs).to(proj_dtype)
    cdt = u[0].dtype

    probe = _drift_probe(ub, btil[:, 0], beta_sq)
    if loss is None:
        loss = probe

    if mode == "auto":
        if bool(probe > _auto_threshold(reorth_tol, acc)):
            u = _subtract(op, Vs, u, _project(op, Vs, u, k, proj_dtype), k)
            beta_sq = _dot(op, u, u).to(proj_dtype)
            ub = _dot(op, u, bs).to(proj_dtype)

    beta_new = _sqrt_rn(torch.clamp(beta_sq, min=0.0))
    # lucky breakdown: the factor's Krylov space is invariant; β stays 0 in H
    beta_new, lucky, safe = _breakdown(beta_new, torch.abs(alpha) + beta + _TINY, cdt)
    v_new = [ui / sf.to(cdt)[:, None] for ui, sf in zip(u, scatter(op, safe))]
    # b̃_k = ⟨u/β, b⟩ = ub/β; a restart replaced v_new, so recompute it then
    bt_new = ub / safe
    if bool(lucky.any()):
        v_new = _replace_lucky(op, Vs, v_new, lucky, k, proj_dtype, deflate_U=deflate_U)
        bt_new = _dot(op, v_new, [x.to(cdt) for x in bs]).to(proj_dtype)

    for Vi, vi in zip(Vs, v_new):
        Vi[k] = vi.to(Vi.dtype)
    H[:, k - 1, k - 1] = alpha
    H[:, k, k - 1] = beta_new
    H[:, k - 1, k] = beta_new
    btil[:, k] = bt_new
    return KrylovState(V, H, btil, beta_new), loss


def arnoldi_step(op, state: KrylovState, b, k: int, *, proj_dtype):
    """One CGS2 Arnoldi step producing basis vector k for all factors: two
    classical Gram–Schmidt sweeps over V[:k], then the lucky-breakdown
    restart where the new vector vanished. Writes column k-1 of the
    Hessenberg H (rows 0..k) and b̃_k in place. Returns (state, loss), the
    loss estimate being the norm of the second sweep's coefficients. op,
    state.V and b are one piece or a ShardedOperator's pieces."""
    V, H, btil, _ = state
    Vs, bs = pieces(V), pieces(b)
    acc = _acc_dtype(Vs[0].dtype, proj_dtype)
    u = spmv_pieces(op, [Vi[k - 1].to(acc) for Vi in Vs])
    w1 = _project(op, Vs, u, k, proj_dtype)
    u = _subtract(op, Vs, u, w1, k)
    w2 = _project(op, Vs, u, k, proj_dtype)
    u = _subtract(op, Vs, u, w2, k)
    h = w1 + w2                                            # (d, k) column entries 0..k-1
    cdt = u[0].dtype

    h_new = _sqrt_rn(_dot(op, u, u).to(proj_dtype))
    h_new, lucky, safe = _breakdown(h_new, torch.sum(torch.abs(h), dim=1) + _TINY, cdt)
    v_new = [ui / sf.to(cdt)[:, None] for ui, sf in zip(u, scatter(op, safe))]
    if bool(lucky.any()):
        v_new = _replace_lucky(op, Vs, v_new, lucky, k, proj_dtype)

    for Vi, vi in zip(Vs, v_new):
        Vi[k] = vi.to(Vi.dtype)
    H[:, :k, k - 1] = h
    H[:, k, k - 1] = h_new
    btil[:, k] = _dot(op, v_new, [x.to(acc) for x in bs]).to(proj_dtype)
    return KrylovState(V, H, btil, h_new), torch.linalg.vector_norm(w2)


def _run_steps(op, b, k, proj_dtype, step):
    if b.dim() == 1:
        b = b[None, :]
    state, _ = init_state(op, b, k, proj_dtype)
    for j in range(1, k + 1):
        state, _ = step(op, state, b, j)
    return state


def lanczos_algorithm(op: KroneckerSumOperator, b, k: int, *, reorth: bool = False, proj_dtype=torch.float64) -> KrylovState:
    """Run k Lanczos steps for every factor. b: (d, n) or (n,)."""
    return _run_steps(op, b, k, proj_dtype,
                      lambda o, st, bb, j: lanczos_step(o, st, bb, j, reorth=reorth, proj_dtype=proj_dtype))


def arnoldi_algorithm(op: KroneckerSumOperator, b, k: int, *, proj_dtype=torch.float64) -> KrylovState:
    """Run k Arnoldi (CGS2) steps for every factor. b: (d, n) or (n,)."""
    return _run_steps(op, b, k, proj_dtype, lambda o, st, bb, j: arnoldi_step(o, st, bb, j, proj_dtype=proj_dtype))


def orthogonality_loss(V: torch.Tensor, k: int, proj_dtype=torch.float64) -> torch.Tensor:
    """‖V_kᵀ V_k − I‖_F over the active prefix, maximized over factors."""
    Vk = V[:k].to(proj_dtype)
    G = torch.einsum("kdn,ldn->dkl", Vk, Vk)
    E = G - torch.eye(k, dtype=proj_dtype, device=V.device)
    return torch.max(torch.sqrt(torch.sum(E * E, dim=(1, 2))))
