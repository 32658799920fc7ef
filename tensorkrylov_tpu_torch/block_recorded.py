"""Noise-recording block Krylov for a rank-R tensor-product RHS: counterpart
of ``tensorkrylov_tpu/block_recorded.py``.

The df64 recording design (``df64_core.py``) carried to the block
recurrence: the columns run in f32 expansion arithmetic with the basis
carried as its stored pair, and every CGS coefficient is recorded exactly as
applied (the f64 value of the applied f32 split), which gives the exact
per-column relation

    A_s v_c = Σ_j H_s[j, c] v_j + dev_c − η_c,

dev measured in expansion arithmetic, η only the elementwise rounding. The
projected solve inverts the recorded factors: the symmetric part sym(H_s)
by an exact host eigendecomposition, the recorded asymmetric defect by a
first-order Fréchet correction whose second-order remainder is charged to the
certificate (``_evaluate_block_recorded``, numpy, the JAX package's
function). The start block is recorded too: a QR of the R start vectors in
expansion arithmetic, b_r = Σ_j btil[j, r] v_j + dev0, so the projected RHS
is the recorded factor, not an orthonormality-conditional Vᵀb. With
deflation (m > 0 or basis=) every new column is U-projected with recorded
coefficients C and the solve inverts [[Λ, C], [0, H]].

Representation as in ``df64_core.py``: V (K, d, n) and U (1, n, m) are f64
tensors holding pair values exactly, so the sweeps, projections, Gram and
assembly are plain f64 GEMMs; H, C, btil, dev and eta_w are f64 records.
The port's extra dev charges are df64_core's (the bands' pair rounding, the
GEMMs' application rounding, B's split, the deflated block's A Ũ − Ũ Λ). ``segment``
sized the JAX package's jitted segment; it is accepted for that signature and
unused.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .coeffs.tables import BHTables, load_tables, select_bh
from .deflate import (DeflationBasis, _assemble, _gershgorin_per_factor, _host, _resolve_final, _sup_error,
                      deflation_basis)
from .df64_core import (BAND_CHARGE_SCALE, _band_rounding, _deflation_residual, _deviation, _df64_gram_deviation_host,
                        _eft_eps, _gamma, _norm, _project_pair_recorded, _round_pair, _split_rounding, _sweep_pair,
                        pair_value)
from .ops import expansion as ex
from .ops.orth import _TINY
from .parallel.sharding import ShardedOperator
from .types import CPTensor, KroneckerSumOperator, SolverConfig, Status
from .utils.cp import cp_residual_cross_check_device, cp_residual_cross_check_host_rankR

__all__ = ["solve_block_recorded", "BlockRecordedResult"]


@dataclasses.dataclass(frozen=True)
class BlockRecordedResult:
    """Result of the recording block solve (mirrors DeflatedResult)."""

    x: Optional[CPTensor]
    status: int
    niterations: int            # block iterations (columns = niterations·R)
    R: int
    relative_residual: List[float]
    certified_bound: List[float]
    checkpoints: List[int]
    expsum_sup: float
    expsum_rank: int
    lambda_min: float
    lambda_max: float
    measured_cp_residual: Optional[float] = None
    cp_residual_floor: Optional[float] = None
    sweep_overlap: Optional[float] = None
    gram_deviation: Optional[float] = None
    relation_dev_term: Optional[float] = None
    relation_eta_term: Optional[float] = None
    relation_r2_term: Optional[float] = None
    perturbation_rho: Optional[float] = None
    eft_eps_measured: Optional[float] = None
    converged: bool = False


@dataclasses.dataclass
class _BlockRecState:
    """The recording block recurrence's state, updated in place."""

    H: torch.Tensor       # (d, Kb, Kb) f64: H[s, j, c] = recorded coefficient of column j in A·v (column c)
    btil: torch.Tensor    # (d, R, R) f64: the recorded QR factor of the start block
    dev: torch.Tensor     # (d, Kb) f64: the exact commit deviation per column
    dev0: torch.Tensor    # (d, R) f64: the start block's representation deviation
    V: torch.Tensor       # (Kb, d, n) f64 holding the basis pairs' values
    sweep_overlap: torch.Tensor   # () f64: max pre-(second)-sweep overlap
    eta_w: torch.Tensor   # (d, Kb) f64: Σ|coefficients| of both CGS passes + the norm, per column (_block_eta)
    C: torch.Tensor       # (d, m, Kb) f64: recorded deflation-projection coefficients per relation column


def _commit_column(st: _BlockRecState, z, col: int, rel_col: int, w_applied, mass) -> None:
    """Normalize, round to the stored pair, record the exact commit deviation
    and the H column (the coefficients, and the norm at row `col`), and the
    applied mass (d,) of the passes' coefficients plus the norm."""
    nrm = _norm(z)
    scale = torch.sum(torch.abs(w_applied), dim=1) + _TINY
    lucky = nrm < 256.0 * torch.finfo(torch.float64).eps * scale
    nrm = torch.where(lucky, 0.0, nrm)
    vh, vl = _round_pair(z, nrm)
    vh = torch.where(lucky[:, None], 0.0, vh)
    vl = torch.where(lucky[:, None], 0.0, vl)
    st.dev[:, col] = _deviation(z, vh, vl, nrm)
    st.H[:, :col, rel_col] = w_applied
    st.H[:, col, rel_col] = nrm
    st.V[col] = vh.to(torch.float64) + vl.to(torch.float64)
    st.eta_w[:, rel_col] = mass + nrm


def _block_rec_advance(bands_h, bands_l, offsets, st: _BlockRecState, k0: int, U, S: int, R: int) -> None:
    """Block steps k0..k0+S-1: each column of the previous block through the
    pair SpMV, the recorded projection (U given), two recorded CGS passes and
    the commit."""
    for k in range(k0, k0 + S):
        for r in range(R):
            src, col, rel_col = (k - 1) * R + r, k * R + r, (k - 1) * R + r
            vh, vl = ex.pair_from_f64(st.V[src])
            z = ex.triple_spmv_pairs(bands_h, bands_l, offsets, vh, vl)
            if U is not None:
                z, c, _ = _project_pair_recorded(U, z)
                st.C[:, :, rel_col] = c
            z, w1, _ = _sweep_pair(st.V, z, col)
            z, w2, ov = _sweep_pair(st.V, z, col)
            st.sweep_overlap = torch.maximum(st.sweep_overlap, ov)
            _commit_column(st, z, col, rel_col, w1 + w2, w1.abs().sum(dim=1) + w2.abs().sum(dim=1))


def _block_rec_init(B: torch.Tensor, st: _BlockRecState, R: int) -> None:
    """The recorded QR of the R start vectors per factor (expansion
    arithmetic): b_r = Σ_{j≤r} btil[s, j, r] v_j + dev0_r exactly, dev0_r the
    measured commit deviation plus the bound on the sweeps' GEMM rounding and
    on the f64 sum of the two passes into btil (as _block_eta)."""
    for r in range(R):
        z = ex.triple_from_f64(B[r])
        z, w1, _ = _sweep_pair(st.V, z, r)
        z, w2, _ = _sweep_pair(st.V, z, r)
        nrm = _norm(z)
        vh, vl = _round_pair(z, nrm)
        mass = w1.abs().sum(dim=1) + w2.abs().sum(dim=1)
        st.dev0[:, r] = _deviation(z, vh, vl, nrm) + (1e-15 + float(_gamma(r)) * (1.0 + 2.0 ** -20)) * mass
        st.btil[:, :r, r] = w1 + w2
        st.btil[:, r, r] = nrm
        st.V[r] = vh.to(torch.float64) + vl.to(torch.float64)


def _block_eta(eta_w: np.ndarray, C: Optional[np.ndarray], eps_elem: float, lam_gersh_f: np.ndarray,
               R: int) -> np.ndarray:
    """The per-column η model (d, Kb): the expansion arithmetic's elementwise
    rounding through the SpMV, sweeps and commit (8 ε λ_g), the f64 sum of
    the two passes' coefficients into H (1e-15 of the mass eta_w), and the
    sweep GEMMs' rounding, γ over the col = c + R columns relation column c
    swept (columns of norm ≤ 1 + 2^-47: the factor 1 + 2^-20); deflated, C
    (d, m, kc) adds (γ_m + 1e-15)·Σ|C| for the lift U c."""
    Kb = eta_w.shape[1]
    eta = 8.0 * eps_elem * lam_gersh_f[:, None] + (1e-15 + _gamma(np.arange(R, Kb + R)) * (1.0 + 2.0 ** -20)) * eta_w
    if C is not None:
        kc = C.shape[2]
        eta[:, :kc] += (1e-15 + _gamma(C.shape[1]) * (1.0 + 2.0 ** -20)) * np.abs(C).sum(axis=1)
    return eta


def _evaluate_block_recorded(H, btil, dev, eta_hat, dev0, kc, R, b_norm,
                             lam_min, omega, alpha, t_mask, eps_elem,
                             lam_gersh_f, gram_dev, frechet: bool = True,
                             lam=None, C_rec=None, c_u=None, e_u=None):
    """Host evaluation of the recorded block solve at kc active columns
    (numpy and longdouble, the JAX package's function; the port adds e_u,
    (d, m) bounds on ‖A_s ũ_j − λ_j ũ_j‖ (df64_core._deflation_residual),
    charged to dev_term through |Yu| as dev is through |Y|).

    Mirrors df64_core._evaluate_host_recorded with:
      tridiagonal T + recorded sweep matrix W  →  sym(H) + asym defect E
      rank-1 β₀e₀ RHS                          →  recorded R-column QR btil
      scalar β boundary                        →  R×R boundary block
    With deflation (lam (d, m), C_rec (d, m, kc), c_u (d, m, R)): the
    recorded per-factor operator is [[Λ, C], [0, sym(H) + E]] — Λ applied
    exactly (diagonal), C and E via first-order Frechet with the
    second-order remainder charged (rho = max_s ||[C_s; E_s]||_F).
    Returns (rel_estimate, Yu (d, m, t·R), Yv (d, kc, t·R), weights,
    components)."""
    ld = np.longdouble
    d = H.shape[0]
    m = 0 if lam is None else lam.shape[1]
    act = np.flatnonzero(t_mask > 0)
    t = act.size
    gam = alpha[act] / lam_min                                  # (t,)
    w_t = omega[act] / lam_min

    Hk = np.asarray(H[:, : kc + R, :kc], np.float64)
    Ha = Hk[:, :kc, :]                                          # active block
    B_blk = Hk[:, kc: kc + R, kc - R: kc]                       # (d, R, R)
    bt = np.zeros((d, kc, R))
    bt[:, :R, :] = btil

    Y = np.zeros((d, kc, t * R))
    Z = np.zeros((d, kc, t * R))
    Yu = np.zeros((d, m, t * R))
    Zu = np.zeros((d, m, t * R))
    rho = 0.0
    for s in range(d):
        S_s = 0.5 * (Ha[s] + Ha[s].T)
        E_s = Ha[s] - S_s
        Cs = np.zeros((0, kc)) if m == 0 else np.asarray(C_rec[s], np.float64)
        rho = max(rho, float(np.sqrt((E_s ** 2).sum() + (Cs ** 2).sum())))
        T_w, Q = np.linalg.eigh(S_s)
        ex = np.exp(-np.clip(T_w[:, None] * gam[None, :], -700.0, 700.0))
        Et = Q.T @ E_s @ Q
        Ct = Cs @ Q if m else None                              # (m, kc)
        ex_u = (np.exp(-np.clip(lam[s][:, None] * gam[None, :], -700., 700.))
                if m else None)
        scale_T = np.abs(T_w).max() + 1.0
        dT = T_w[:, None] - T_w[None, :]
        deg = np.abs(dT) < 1e-8 * scale_T
        if m:
            dU = lam[s][:, None] - T_w[None, :]
            degU = np.abs(dU) < 1e-8 * scale_T
        for r in range(R):
            g = Q.T @ bt[s, :, r]                               # (kc,)
            Y0 = Q @ (ex * g[:, None])                          # (kc, t)
            dY = np.zeros((kc, t))
            dYu = np.zeros((m, t))
            Yu0 = ex_u * c_u[s][:, r][:, None] if m else None   # (m, t)
            if frechet:
                # GEMM-separated divided differences (see
                # df64_core._evaluate_host_recorded for the derivation)
                Gw = Et * g[None, :]
                M = np.where(deg, 0.0, Gw) / np.where(deg, 1.0, dT)
                dY_c = ex * M.sum(axis=1)[:, None] - M @ ex
                for i, l in zip(*np.nonzero(deg)):
                    h = 0.5 * gam * (T_w[i] - T_w[l])
                    dY_c[i] += Gw[i, l] * (-gam * np.sqrt(ex[i] * ex[l])
                                           * (1.0 + h * h / 6.0))
                dY = Q @ dY_c
                if m:
                    Gu = Ct * g[None, :]
                    MU = np.where(degU, 0.0, Gu) / np.where(degU, 1.0, dU)
                    dYu = ex_u * MU.sum(axis=1)[:, None] - MU @ ex
                    for i, l in zip(*np.nonzero(degU)):
                        h = 0.5 * gam * (lam[s][i] - T_w[l])
                        dYu[i] += Gu[i, l] * (-gam * np.sqrt(ex_u[i] * ex[l])
                                              * (1.0 + h * h / 6.0))
            Y[s, :, r * t: (r + 1) * t] = Y0 + dY
            if m:
                Yu[s, :, r * t: (r + 1) * t] = Yu0 + dYu
        Z[s] = Ha[s] @ Y[s]
        if m:
            Zu[s] = lam[s][:, None] * Yu[s] + Cs @ Y[s]

    w_full = np.tile(w_t, R)                                    # (t·R,)
    wl = np.asarray(w_full, ld)
    # joint factors: [U-block rows | Krylov rows] — the Gram algebra runs
    # over the concatenation exactly as df64_core._evaluate_host_recorded
    Yj = np.concatenate([Yu, Y], axis=1)
    Zj = np.concatenate([Zu, Z], axis=1)
    btj = np.concatenate(
        [np.zeros((d, m, R)) if c_u is None else c_u, bt], axis=1)
    Gy = np.einsum("dpi,dpj->dij", Yj, Yj).astype(ld)
    Gz = np.einsum("dpi,dpj->dij", Zj, Zj).astype(ld)
    Xg = np.einsum("dpi,dpj->dij", Yj, Zj).astype(ld)
    yb = np.einsum("dpi,dpr->dir", Yj, btj).astype(ld)          # (d, tR, R)
    zb = np.einsum("dpi,dpr->dir", Zj, btj).astype(ld)
    Gb = np.einsum("dpr,dpq->drq", btj, btj).astype(ld)
    b2 = float(np.sum(np.prod(Gb, axis=0)))

    hy2 = ld(0.0)
    for s in range(d):
        for sp in range(d):
            P = np.ones((t * R, t * R), ld)
            for mo in range(d):
                if mo == s and mo == sp:
                    P *= Gz[mo]
                elif mo == s:
                    P *= Xg[mo].T
                elif mo == sp:
                    P *= Xg[mo]
                else:
                    P *= Gy[mo]
            hy2 += wl @ P @ wl
    ip = ld(0.0)
    for s in range(d):
        P = np.ones((t * R, R), ld)
        for mo in range(d):
            P *= zb[mo] if mo == s else yb[mo]
        ip += wl @ P.sum(axis=1)
    r_comp_sq = float(hy2 - 2.0 * ip + b2)

    # block boundary (Lemma 3.4, block form): unaccounted term per mode s
    # is V_newblock · (B_s Y_last_s) ⊗ off-modes; cross-mode terms are
    # orthogonality-slack-second-order (folded into `slack` below)
    Y_last = Y[:, kc - R: kc, :]                                # (d, R, tR)
    boundary = ld(0.0)
    for s in range(d):
        E_off = np.ones((t * R, t * R), ld)
        for mo in range(d):
            if mo != s:
                E_off *= Gy[mo]
        Wb = (B_blk[s] @ Y_last[s]).astype(ld)                  # (R, tR)
        boundary += wl @ ((Wb.T @ Wb) * E_off) @ wl
    boundary = float(boundary)

    # relation-error terms: dev measured exactly; η from the measured
    # elementwise ε and the applied-coefficient mass (||H col||_1 incl.
    # both CGS passes enters via eta_w, passed in dev's companion below)
    slack = float(np.sqrt(1.0 + min(kc, 1e9) * max(gram_dev, 0.0)))
    ynorm = np.sqrt(np.maximum(
        np.einsum("dii->di", np.asarray(Gy, np.float64)), 0.0))
    off_prod = np.ones((d, t * R))
    for s in range(d):
        for r_ in range(d):
            if r_ != s:
                off_prod[s] *= ynorm[r_] * slack

    def tri_term(bmat, Yf=Y):   # bmat (d, kc) per-column relation bounds
        tot = 0.0
        for s in range(d):
            Dsi = np.abs(Yf[s]).T @ bmat[s]
            tot += float(np.sum(np.abs(w_full) * Dsi * off_prod[s]))
        return tot

    # dev[:, c] must already be the deviation of RELATION column c (the
    # commit of column c+R) — solve_block_recorded shifts by R before calling
    dev_term = tri_term(dev[:, :kc]) * slack / b_norm
    # start-block representation deviation: b_r − Σ_j btil[j,r] v_j has
    # norm dev0[s, r] in factor s; its full-tensor contribution carries the
    # off-mode ||b_{mo,r}|| products (b_norms_dr passed via dev0's second
    # row block — see solve_block_recorded)
    eta_term = tri_term(eta_hat[:, :kc]) * slack / b_norm
    dev_term += float(np.sum(dev0)) / b_norm
    if e_u is not None and m:
        dev_term += tri_term(e_u, Yu) * slack / b_norm
    lam_max_tot = float(np.sum(lam_gersh_f))
    gr = gam * rho
    r2_term = float(d * lam_max_tot * np.sum(
        w_t * 0.5 * gr * gr * np.exp(np.minimum(gr, 50.0)))) if frechet \
        else 0.0

    rel = float(np.sqrt(max(boundary, 0.0) + max(r_comp_sq, 0.0))) / b_norm
    components = {
        "boundary": float(np.sqrt(max(boundary, 0.0))) / b_norm,
        "dev_term": dev_term,
        "eta_term": eta_term,
        "r2_term": r2_term,
        "rho": float(rho),
        "gram_dev": float(gram_dev),
        "eps_elem": float(eps_elem),
    }
    return rel, Yu, Y, w_full, components


def solve_block_recorded(
    op: KroneckerSumOperator,
    B,
    config: Optional[SolverConfig] = None,
    tables: Optional[BHTables] = None,
    checkpoints: Optional[Sequence[int]] = None,
    lam_min: Optional[float] = None,
    segment: int = 8,
    certify: bool = True,
    final: str = "auto",
    m: int = 0,
    basis: Optional[DeflationBasis] = None,
    verbose: bool = False,
) -> BlockRecordedResult:
    """Certifying block Krylov solve for a rank-R RHS b = Σ_r ⊗_s B[r, s],
    B (R, d, n), on the operator's device: the noise-recording counterpart of
    solve_block.

    lam_min: an exact lower spectral bound of the joint operator (e.g.
    d·λ_min(A_s) for identical SPD factors), which a rigorous certificate
    needs; with None (and no deflation) each checkpoint uses the least Ritz
    value, which approaches λ_min from above (estimate-grade sup).

    final: 'host' assembles x on the host in numpy and runs the numpy rank-R
    cross-check; 'device' assembles x = V·Y + U·Yu on the operator's device
    and runs the compensated device cross-check there; 'auto' is 'device' on
    a CUDA operator and 'host' otherwise.

    m / basis: per-factor spectral deflation composed with the block
    recurrence: B is projected into the U-complement on the host (recorded
    coefficients c_u), every new column is U-projected with recorded
    coefficients C, and the solve inverts the recorded [[Λ, C], [0, H]].
    It needs a shared deflation basis (identical factors).
    """
    config = config or SolverConfig()
    if isinstance(op, ShardedOperator):
        raise NotImplementedError(
            "solve_block_recorded has no mesh: the JAX package's has none either (VERDICT r5's one open gap); "
            "run it on the unsharded operator, or solve_block(sop, B) for the uncertified sharded block solve")
    dev = op.device
    B = torch.as_tensor(B)
    if B.dim() != 3 or B.shape[1] != op.d or B.shape[2] != op.n:
        raise ValueError(f"B must be (R, d, n) = (R, {op.d}, {op.n}), got {tuple(B.shape)}")
    if not op.symmetric:
        raise ValueError("solve_block_recorded requires a symmetric operator")
    R = int(B.shape[0])
    d, n = op.d, op.n
    pdt = torch.float64
    tables = tables or load_tables(dtype=pdt)
    final = _resolve_final(final, dev)

    # deflation setup (host): B projected into the U-complement with exact
    # host-f64 recorded coefficients c_u
    U = lam_np = c_u_np = None
    split = np.zeros((op.d, int(B.shape[0])))
    if basis is not None:
        m = basis.m
    elif m > 0:
        basis = deflation_basis(op, m)
        m = basis.m
    B_np = _host(B)
    B_work = B_np
    if m > 0:
        U_np = np.asarray(basis.U, np.float64)
        if U_np.shape[0] != 1:
            raise ValueError("solve_block_recorded deflation requires a shared basis (identical factors), like "
                             "storage='df64'")
        lam_np = np.asarray(basis.lam, np.float64)
        c_u_np = np.einsum("nm,rdn->dmr", U_np[0], B_np)        # (d, m, R)
        B_work = B_np - np.einsum("nm,dmr->rdn", U_np[0], c_u_np)
        U64 = torch.from_numpy(U_np).to(dev)
        U = pair_value(U64)                                                # (1, n, m)
        split = _split_rounding(U64, U, torch.from_numpy(B_np).to(dev).permute(1, 2, 0),
                                torch.from_numpy(c_u_np).to(dev))         # (d, R)
        del U_np, U64
        if lam_min is None:
            lam_min = float(lam_np[:, 0].sum())   # exact joint λ_min

    kmax = min(config.kmax, max((n - m) // R - 1, 1))           # block iterations
    Kb = (kmax + 1) * R
    lam_gersh_f = _gershgorin_per_factor(op)
    lam_max = float(lam_gersh_f.sum())
    band_charge = _band_rounding(_host(op.bands), op.offsets) * BAND_CHARGE_SCALE
    Gb0 = np.einsum("rdn,qdn->drq", B_np, B_np)
    b_norm = float(np.sqrt(max(np.sum(np.prod(Gb0, axis=0)), 0.0)))

    if checkpoints is None:
        checkpoints, ck = [], 8
        while ck < kmax:
            checkpoints.append(ck)
            ck *= 2
        checkpoints.append(kmax)
    checkpoints = sorted({min(int(c_), kmax) for c_ in checkpoints})

    def coeffs_for(lmin):
        # a fixed interval when lam_min is given (exact), else refreshed per checkpoint from the Ritz minimum
        kappa = lam_max / lmin
        half_tol = 0.5 * config.tol
        coeff_tol = half_tol / kappa if config.coeff_tol_scale == "kappa" else half_tol
        co = select_bh(torch.tensor(kappa, dtype=pdt), coeff_tol, tables, config.tmax, config.bh_row_select)
        return co, _sup_error(co, kappa, dev)

    bands_h, bands_l = ex.pair_from_f64(op.bands.to(pdt))
    eps_elem = _eft_eps(dev)
    e_u = None if m == 0 else _deflation_residual(op.bands, op.offsets, U, lam_np, eps_elem, lam_gersh_f)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=dev)

    st = _BlockRecState(H=zeros(d, Kb, Kb), btil=zeros(d, R, R), dev=zeros(d, Kb), dev0=zeros(d, R),
                        V=zeros(Kb, d, n), sweep_overlap=zeros(), eta_w=zeros(d, Kb), C=zeros(d, m, Kb))
    _block_rec_init(torch.from_numpy(B_work).to(dev), st, R)

    rel_hist: List[float] = []
    bound_hist: List[float] = []
    status = int(Status.MAXITER)
    k_prev, k_done = 1, 0
    cert = coeffs = None
    lam_min_eff = lam_min
    b_col_norms = np.linalg.norm(B_np, axis=2).T                # (d, R)
    off_b = np.ones((d, R))
    for s_ in range(d):
        for mo in range(d):
            if mo != s_:
                off_b[s_] *= b_col_norms[mo]

    for ck in checkpoints:
        if k_prev <= ck:
            _block_rec_advance(bands_h, bands_l, op.offsets, st, k_prev, U, ck + 1 - k_prev, R)
            k_prev = ck + 1
        kc = ck * R
        H_np = np.zeros((d, Kb, Kb))
        H_np[:, :kc + R, :kc] = _host(st.H[:, :kc + R, :kc])
        btil_np = _host(st.btil)
        # relation column c's commit deviation was recorded at column c+R; A·v_c applied the bands' pair value
        dev_np = _host(st.dev)[:, R:kc + R] + band_charge[:, None]
        # the start block's representation: the measured QR commit deviation with its sweeps' GEMM rounding,
        # the init's elementwise rounding and the deflation split's, weighted by the off-mode ‖b_{mo,r}‖
        # products so that the sum is in absolute b-units
        dev0_np = (_host(st.dev0) + 8.0 * eps_elem * np.abs(btil_np).sum(axis=1) + split) * off_b
        if lam_min is None:
            # Ritz lower estimate from the symmetrized joint blocks
            lmins = [float(np.linalg.eigvalsh(0.5 * (H_np[s, :kc, :kc] + H_np[s, :kc, :kc].T))[0])
                     for s in range(d)]
            lam_min_eff = max(sum(lmins), 1e-300)
        coeffs, sup_err = coeffs_for(lam_min_eff)
        C_np = _host(st.C[:, :, :kc]) if m > 0 else None         # (d, m, kc)
        eta_hat = _block_eta(_host(st.eta_w), C_np, eps_elem, lam_gersh_f, R)
        omega, alpha, t_mask = (_host(a) for a in (coeffs.omega, coeffs.alpha, coeffs.t_mask))

        def evaluate(gram_dev):
            rel, Yu, Y, w_full, comp = _evaluate_block_recorded(
                H_np, btil_np, dev_np, eta_hat, dev0_np, kc, R, b_norm, lam_min_eff, omega, alpha, t_mask,
                eps_elem, lam_gersh_f, gram_dev, frechet=True, lam=lam_np, C_rec=C_np, c_u=c_u_np, e_u=e_u)
            comp["sup"] = sup_err
            bound = sup_err + comp["boundary"] + comp["dev_term"] + comp["eta_term"] + comp["r2_term"]
            return rel, Yu, Y, w_full, comp, bound

        rel, Yu_np, Y_np, w_np, cert, bound = evaluate(float(st.sweep_overlap))
        if bound < 100.0 * config.tol or ck == checkpoints[-1]:
            rel, Yu_np, Y_np, w_np, cert, bound = evaluate(_df64_gram_deviation_host(st.V, kc))
            cert["gram_source"] = "measured full Gram"
        else:
            cert["gram_source"] = "proxy sweep_overlap"
        rel_hist.append(rel)
        bound_hist.append(bound)
        k_done = ck
        if verbose:
            print(f"  [solve_block_recorded] k={ck} ({kc} cols): estimate {rel:.3e}, certified bound {bound:.3e} "
                  f"[sup {sup_err:.1e} bnd {cert['boundary']:.1e} dev {cert['dev_term']:.1e} "
                  f"rho {cert['rho']:.1e} gram {cert['gram_dev']:.1e}]", flush=True)
        if bound < config.tol:
            status = int(Status.CONVERGED)
            break

    # ---- assembly + basis-free rank-R cross-check ----
    kc = k_done * R
    measured = measured_floor = None
    if final == "device":
        w_dev = torch.from_numpy(w_np).to(dev)
        Y_dev = torch.from_numpy(Y_np).to(dev)
        if m > 0:
            xf = _assemble(U, st.V, torch.from_numpy(Yu_np).to(dev), Y_dev, kc)
        else:
            xf = torch.bmm(st.V[:kc].permute(1, 2, 0), Y_dev)
        x = CPTensor(w_dev, xf)
        if certify:
            check = cp_residual_cross_check_device(op, w_dev, xf, B)
            measured, measured_floor = check.value / b_norm, check.floor / b_norm
    else:
        xf = np.einsum("kdn,dkt->dnt", _host(st.V[:kc]), Y_np)
        if m > 0:
            xf = xf + np.einsum("nm,dmt->dnt", np.asarray(basis.U, np.float64)[0], Yu_np)
        x = CPTensor(torch.from_numpy(w_np), torch.from_numpy(xf))
        if certify:
            check = cp_residual_cross_check_host_rankR(_host(op.bands), op.offsets, w_np, xf, B_np)
            measured, measured_floor = check.value / b_norm, check.floor / b_norm

    return BlockRecordedResult(
        x=x,
        status=status,
        niterations=k_done,
        R=R,
        relative_residual=rel_hist,
        certified_bound=bound_hist,
        checkpoints=list(checkpoints[:len(rel_hist)]),
        expsum_sup=float(cert["sup"]),
        expsum_rank=int(np.sum(_host(coeffs.t_mask) > 0)),
        lambda_min=float(lam_min_eff),
        lambda_max=lam_max,
        measured_cp_residual=measured,
        cp_residual_floor=measured_floor,
        sweep_overlap=float(st.sweep_overlap),
        gram_deviation=cert["gram_dev"],
        relation_dev_term=cert["dev_term"],
        relation_eta_term=cert["eta_term"],
        relation_r2_term=cert["r2_term"],
        perturbation_rho=cert["rho"],
        eft_eps_measured=eps_elem,
        converged=status == int(Status.CONVERGED),
    )
