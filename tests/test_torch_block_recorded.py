"""The port's noise-recording block solver (block_recorded.py) on the CPU:
twins of tests/test_block_recorded.py, each asserting on the port what the
JAX test asserts on the JAX package (the certified bound dominates the
dense-oracle residual, d ≤ 3, n ≤ 48); the port against the JAX package on
the same inputs; and the certificate's premise, the recorded relation,
column by column in longdouble.

The recorded coefficients and the η term are roundoff records (the port's
arithmetic is exact, the JAX CPU jit's pair-grade) and are not compared with
the JAX package's; status, steps, checkpoints and bounds are."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu import block_recorded as jbr
from tensorkrylov_tpu_torch import block_recorded as br, df64_core
from tensorkrylov_tpu_torch.ops import expansion as ex
from tensorkrylov_tpu_torch.utils.cp import cp_full, kron_matvec_dense

torch.set_num_threads(1)

# port against JAX: a bound is sup + boundary + the relation terms (dev, η, and r2 ∝ ρ², ρ the norm of the
# recorded asymmetric defect and projection coefficients). sup + boundary agree to 1e-10 relative beside
# 1e-15 absolute (where the bound is ~1e-9 its boundary is a product of the recorded H, which the two
# packages round apart at the JAX CPU jit's pair grade; tests/test_torch_deflate.py's BOUND_ATOL). The
# relation terms are roundoff records: the bounds agree up to them
BOUND_RTOL, BOUND_ATOL = 1e-10, 1e-15


def _problem(d=3, n=32, R=2, shift=20.0, seed=1):
    op = tkt.laplace(d, n, shift=shift, device="cpu")
    B = np.random.default_rng(seed).standard_normal((R, d, n))
    lmin = d * float(np.linalg.eigvalsh(tkt.bands_to_dense(op)[0])[0])
    return op, B, lmin


def _true_rel(op, B, x):
    d, n = op.d, op.n
    b_full = np.zeros(n ** d)
    for r in range(B.shape[0]):
        acc = np.array([1.0])
        for s in range(d):
            acc = np.kron(acc, B[r, s])
        b_full += acc
    Gb = np.einsum("rdn,qdn->drq", B, B)
    bn = float(np.sqrt(np.sum(np.prod(Gb, axis=0))))
    return float(np.linalg.norm(b_full - kron_matvec_dense(op, cp_full(x)))) / bn


# ---- twins of tests/test_block_recorded.py ----

def test_bound_dominates_true_residual():
    op, B, lmin = _problem()
    res = tkt.solve_block_recorded(op, B, tkt.SolverConfig(kmax=15, tol=1e-30), lam_min=lmin, final="host")
    rel_true = _true_rel(op, B, res.x)
    bound = res.certified_bound[-1]
    assert rel_true <= 1.05 * bound + 1e-15
    assert bound <= 50.0 * max(rel_true, res.cp_residual_floor)
    assert abs(res.measured_cp_residual - rel_true) <= 4 * res.cp_residual_floor


def test_converges_and_certifies():
    op, B, lmin = _problem(d=2, n=48, R=2, shift=2000.0)
    res = tkt.solve_block_recorded(op, B, tkt.SolverConfig(kmax=23, tol=1e-8), lam_min=lmin, final="host")
    assert res.converged, (res.certified_bound, res.relative_residual)
    assert res.certified_bound[-1] < 1e-8
    assert _true_rel(op, B, res.x) <= 1.05 * res.certified_bound[-1] + 1e-15


def test_device_final_matches_host_final():
    op, B, lmin = _problem(d=2, n=40, R=3, shift=30.0)
    cfg = tkt.SolverConfig(kmax=12, tol=1e-30)
    rh = tkt.solve_block_recorded(op, B, cfg, lam_min=lmin, final="host")
    rd = tkt.solve_block_recorded(op, B, cfg, lam_min=lmin, final="device")
    np.testing.assert_array_equal(rd.certified_bound, rh.certified_bound)
    xh = rh.x.factors.numpy()
    np.testing.assert_allclose(rd.x.factors.numpy(), xh, rtol=0, atol=1e-12 * np.abs(xh).max())
    band = 2.0 * max(rd.cp_residual_floor, rh.cp_residual_floor)
    assert abs(rd.measured_cp_residual - rh.measured_cp_residual) <= band + 1e-12


def test_ritz_lam_min_fallback():
    op, B, _ = _problem(d=2, n=32, R=2, shift=30.0)
    res = tkt.solve_block_recorded(op, B, tkt.SolverConfig(kmax=15, tol=1e-8), lam_min=None, final="host")
    assert abs(res.measured_cp_residual - _true_rel(op, B, res.x)) <= 4 * res.cp_residual_floor


def test_shared_subspace_beats_separate_columns():
    """R right-hand sides in one shared block space converge within the
    column budget of separate rank-1 solves."""
    op, B, lmin = _problem(d=2, n=48, R=2, shift=2000.0)
    res = tkt.solve_block_recorded(op, B, tkt.SolverConfig(kmax=23, tol=1e-8), lam_min=lmin, final="host")
    assert res.converged
    r1 = tkt.solve(op, torch.tensor(B[0] / np.linalg.norm(B[0], axis=1, keepdims=True)),
                   tkt.SolverConfig(kmax=47, tol=1e-8, identical_factors=False))
    assert res.niterations * res.R <= 2 * int(r1.niterations) + 2 * res.R


def test_deflated_block_composition():
    """Deflation composed with the block recurrence: a solve that stalls
    undeflated certifies below tol with m > 0 in fewer block iterations, the
    dense oracle and the cross-check confirming the bound."""
    op, B, lmin = _problem(d=2, n=48, R=2, shift=30.0, seed=3)
    cfg = tkt.SolverConfig(kmax=23, tol=1e-8)
    r0 = tkt.solve_block_recorded(op, B, cfg, lam_min=lmin, final="host")
    rm = tkt.solve_block_recorded(op, B, cfg, m=8, final="host")
    assert not r0.converged and r0.certified_bound[-1] > 1e-5
    assert rm.converged and rm.certified_bound[-1] < 1e-8
    assert rm.niterations <= r0.niterations
    rel_true = _true_rel(op, B, rm.x)
    assert rel_true <= 1.05 * rm.certified_bound[-1] + 1e-15
    assert abs(rm.measured_cp_residual - rel_true) <= 4 * rm.cp_residual_floor


def test_deflated_block_device_final_matches_host():
    op, B, _ = _problem(d=2, n=40, R=2, shift=30.0, seed=4)
    cfg = tkt.SolverConfig(kmax=10, tol=1e-30)
    rh = tkt.solve_block_recorded(op, B, cfg, m=6, final="host")
    rd = tkt.solve_block_recorded(op, B, cfg, m=6, final="device")
    np.testing.assert_array_equal(rd.certified_bound, rh.certified_bound)
    xh = rh.x.factors.numpy()
    np.testing.assert_allclose(rd.x.factors.numpy(), xh, rtol=0, atol=1e-12 * np.abs(xh).max())


# ---- the port against the JAX package ----

CASES = {   # name: (_problem arguments, config fields, solve_block_recorded keywords)
    "plain": (dict(d=2, n=48, R=2, shift=2000.0), dict(kmax=23, tol=1e-8), {}),
    "deflated": (dict(d=2, n=48, R=2, shift=30.0, seed=3), dict(kmax=23, tol=1e-8), dict(m=8)),
}


@pytest.fixture(scope="module")
def jax_block():
    """The JAX package's solve of a case, once per module."""
    cache = {}

    def run(name):
        if name not in cache:
            pa, fields, kw = CASES[name]
            op, B, lmin = _problem(**pa)
            jop = tk.laplace(pa["d"], pa["n"], shift=pa["shift"])
            cache[name] = tk.solve_block_recorded(jop, jnp.asarray(B), tk.SolverConfig(**fields),
                                                  lam_min=None if kw else lmin, final="host", **kw)
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_block_recorded_matches_jax(name, jax_block):
    """Status, block steps, checkpoints and the exp-sum rank equal; sup +
    boundary of the deciding bound, the spectral interval and the sup to the
    tolerances above, every bound up to the relation terms; both bounds
    above the dense oracle."""
    pa, fields, kw = CASES[name]
    op, B, lmin = _problem(**pa)
    ref = jax_block(name)
    res = tkt.solve_block_recorded(op, B, tkt.SolverConfig(**fields), lam_min=None if kw else lmin, final="host",
                                   **kw)
    assert (res.status, res.niterations, res.checkpoints, res.R, res.expsum_rank) == (
        int(ref.status), ref.niterations, ref.checkpoints, ref.R, ref.expsum_rank)
    def relation(x):
        return x.relation_dev_term + x.relation_eta_term + x.relation_r2_term

    slack = max(relation(res), relation(ref))
    for a, r in zip(res.certified_bound, ref.certified_bound):
        assert abs(a - r) <= BOUND_RTOL * r + BOUND_ATOL + slack, (a, r, slack)
    np.testing.assert_allclose(res.certified_bound[-1] - relation(res), ref.certified_bound[-1] - relation(ref),
                               rtol=BOUND_RTOL, atol=BOUND_ATOL)
    np.testing.assert_allclose([res.lambda_min, res.lambda_max, res.expsum_sup],
                               [ref.lambda_min, ref.lambda_max, ref.expsum_sup], rtol=1e-12)
    rel_true = _true_rel(op, B, res.x)
    assert rel_true <= res.certified_bound[-1] and rel_true <= ref.certified_bound[-1]


def test_evaluate_block_recorded_equals_jax():
    """The host evaluation is the JAX package's numpy code: equal outputs on
    identical inputs (an H with a small asymmetric defect, deflated)."""
    rng = np.random.default_rng(5)
    d, R, kc, m, Kp = 2, 2, 8, 3, 16
    H = np.zeros((d, Kp, Kp))
    for s in range(d):
        S = rng.standard_normal((kc + R, kc + R))
        H[s, :kc + R, :kc + R] = 5.0 * np.eye(kc + R) + 0.3 * (S + S.T) + 1e-6 * rng.standard_normal(S.shape)
    btil = np.triu(rng.standard_normal((d, R, R))) + np.eye(R)
    dev, eta_hat = np.abs(rng.standard_normal((d, kc))) * 1e-14, np.full((d, Kp), 1e-15)
    lam = np.sort(rng.uniform(0.5, 1.0, (d, m)))
    co = tkt.coeffs.tables.select_bh(torch.tensor(40.0, dtype=torch.float64), 1e-8, tkt.coeffs.tables.load_tables())
    omega, alpha, t_mask = (t.numpy() for t in (co.omega, co.alpha, co.t_mask))
    args = (H, btil, dev, eta_hat, np.full((d, R), 1e-16), kc, R, 1.0, float(lam[:, 0].sum()), omega, alpha,
            t_mask, 1e-19, np.full(d, 10.0), 1e-15)
    kw = dict(lam=lam, C_rec=rng.standard_normal((d, m, kc)) * 1e-9, c_u=rng.standard_normal((d, m, R)))
    mine, ref = br._evaluate_block_recorded(*args, **kw), jbr._evaluate_block_recorded(*args, **kw)
    assert mine[0] == ref[0] and mine[4] == ref[4]
    for a, r in zip(mine[1:4], ref[1:4]):
        np.testing.assert_array_equal(a, r)


# ---- the certificate's premise ----

def test_recorded_relation_holds_every_column():
    """For every relation column c and factor s, in longdouble with the
    operator's own bands: ‖A v_c − (Σ_j H[j, c] v_j + U C[:, c])‖ ≤ dev_c + η̂_c,
    H and C the recorded applied coefficients, dev_c the recorded commit
    deviation of column c + R plus the bands' pair rounding, η̂_c solve_block_recorded's
    η model (block_recorded._block_eta); and the start block's
    b_r = Σ_j btil[j, r] v_j within dev0_r + 8 ε Σ|btil[:, r]|."""
    d, n, R, m, steps = 2, 40, 2, 4, 8
    op = tkt.reaction_diffusion(d, n, sigma=1.0 / 3.0, device="cpu")
    basis = tkt.deflation_basis(op, m)
    U = df64_core.pair_value(torch.tensor(basis.U))
    B = np.random.default_rng(6).standard_normal((R, d, n))
    U0 = basis.U[0]
    B = B - np.einsum("nm,dmr->rdn", U0, np.einsum("nm,rdn->dmr", U0, B))
    Kb = (steps + 1) * R

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float64)

    st = br._BlockRecState(H=zeros(d, Kb, Kb), btil=zeros(d, R, R), dev=zeros(d, Kb), dev0=zeros(d, R),
                           V=zeros(Kb, d, n), sweep_overlap=zeros(), eta_w=zeros(d, Kb), C=zeros(d, m, Kb))
    br._block_rec_init(torch.tensor(B), st, R)
    br._block_rec_advance(*ex.pair_from_f64(op.bands), op.offsets, st, 1, U, steps, R)

    ld = np.longdouble
    A = tkt.bands_to_dense(op).astype(ld)
    V, H, C = st.V.numpy().astype(ld), st.H.numpy().astype(ld), st.C.numpy().astype(ld)
    Up = U.numpy().astype(ld)[0]
    dev, btil, dev0 = st.dev.numpy(), st.btil.numpy(), st.dev0.numpy()
    eps = df64_core._eft_eps("cpu")
    lam_g = tkt.deflate._gershgorin_per_factor(op)
    eta_hat = br._block_eta(st.eta_w.numpy(), st.C.numpy()[:, :, :steps * R], eps, lam_g, R)
    band = df64_core._band_rounding(op.bands.numpy(), op.offsets) * df64_core.BAND_CHARGE_SCALE
    assert band.min() > 0.0
    for s in range(d):
        for r in range(R):
            err = float(np.sqrt(np.sum((B[r, s].astype(ld) - btil[s, :, r].astype(ld) @ V[:R, s]) ** 2)))
            assert err <= dev0[s, r] + 8.0 * eps * float(np.abs(btil[s, :, r]).sum()) + 1e-300, (s, r, err)
        for c in range(steps * R):
            rhs = H[s, :c + R + 1, c] @ V[:c + R + 1, s] + Up @ C[s, :, c]
            err = float(np.sqrt(np.sum((A[s] @ V[c, s] - rhs) ** 2)))
            eta = eta_hat[s, c]
            assert err <= dev[s, c + R] + band[s] + eta, (s, c, err, dev[s, c + R], band[s], eta)


@pytest.mark.parametrize("charged", [True, False])
def test_rotated_basis_defect_is_charged(charged, monkeypatch):
    """A deflation basis that is orthonormal but not invariant (each
    eigenvector turned by 1e-6 toward another), B with a large share in its
    span: the evaluation takes A Ũ = Ũ Λ, so the bound must carry the
    measured defect (df64_core._deflation_residual). With it the bound
    dominates the dense oracle; with the defect's charge set to 0 the oracle
    exceeds the bound tenfold."""
    d, n, m, R = 2, 48, 6, 2
    op = tkt.laplace(d, n, shift=2000.0, device="cpu")
    lam, Q = np.linalg.eigh(tkt.bands_to_dense(op)[0])
    theta = 1e-6
    U = Q[:, :m] * np.cos(theta) + Q[:, m:2 * m] * np.sin(theta)
    basis = tkt.DeflationBasis(U=U[None], lam=np.tile(lam[:m], (d, 1)))
    if not charged:
        monkeypatch.setattr(br, "_deflation_residual", lambda *a, **k: np.zeros((d, m)))
    B = np.random.default_rng(8).standard_normal((R, d, n))
    B[0] += 3.0 * U[:, 0]
    res = tkt.solve_block_recorded(op, B, tkt.SolverConfig(kmax=16, tol=1e-10), lam_min=d * float(lam[0]),
                                   basis=basis, final="host")
    rel_true = _true_rel(op, B, res.x)
    assert rel_true > 1e-8            # the defect's share of the residual, far above the solve's own
    if charged:
        assert rel_true <= res.certified_bound[-1], (rel_true, res.certified_bound)
    else:
        assert rel_true > 10.0 * res.certified_bound[-1], (rel_true, res.certified_bound)


def test_final_auto_is_host_on_the_cpu(monkeypatch):
    """final='auto' on a CPU operator assembles and cross-checks on the host:
    the device cross-check is never called and the result equals final='host'."""
    op, B, lmin = _problem(d=2, n=24, R=2, shift=30.0)
    cfg = tkt.SolverConfig(kmax=6, tol=1e-30)
    rh = tkt.solve_block_recorded(op, B, cfg, lam_min=lmin, final="host")

    def refuse(*args, **kwargs):
        raise AssertionError("final='auto' ran the device cross-check on a CPU operator")

    monkeypatch.setattr(br, "cp_residual_cross_check_device", refuse)
    ra = tkt.solve_block_recorded(op, B, cfg, lam_min=lmin)
    assert ra.certified_bound == rh.certified_bound and ra.measured_cp_residual == rh.measured_cp_residual
    assert torch.equal(ra.x.factors, rh.x.factors)
