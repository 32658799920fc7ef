"""The port's storage='df64' (df64_core.py and deflate.py's _solve_df64) on
the CPU: twins of tests/test_df64_device_final.py, tests/test_df64_resume.py
and tests/test_deflate.py's three df64 tests, each asserting on the port
what the JAX test asserts on the JAX package; the port against the JAX
package on the same inputs; the state cache across the two packages; and the
certificate's premise, the recorded relation, step by step in longdouble.

The sweep and projection coefficients (W, C) and the η term are roundoff
records: the port's exact expansion arithmetic and the JAX CPU jit's
pair-grade one record different roundoff, so they are not compared with the
JAX package's. What the recurrence computes (α, β, the bounds) is."""
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu import df64_core as jdf64
from tensorkrylov_tpu_torch import df64_core
from tensorkrylov_tpu_torch.coeffs.tables import load_tables, select_bh
from tensorkrylov_tpu_torch.ops import expansion as ex
from tensorkrylov_tpu_torch.ops.orth import deflation_project
from tensorkrylov_tpu_torch.utils.cp import (cp_full, cp_residual_cross_check_device, cp_residual_cross_check_host,
                                             kron_matvec_dense)

torch.set_num_threads(1)

# the port against the JAX package at d=2, n=64 (tests/test_deflate.py's df64 case): α and β of the recorded
# recurrence to 1e-12 relative; the certified bound, a sum of positives, to 1e-10 up to the relation terms
# (dev, η, r2: roundoff records, and the port charges more to dev: the deflated block's A Ũ − Ũ Λ and the
# GEMMs' rounding); the estimate's compressed part cancels to eps·‖b̃‖², so estimates to 2√eps absolute
# beside 1e-8 (tests/test_torch_deflate.py)
TRIDIAG_RTOL = 1e-12
BOUND_RTOL = 1e-10
EST_RTOL, EST_ATOL = 1e-8, 2.0 * math.sqrt(np.finfo(np.float64).eps)


def _relation(res):
    return res.relation_dev_term + res.relation_eta_term + res.relation_r2_term


def _assert_bounds_agree(res, ref):
    """Every bound to BOUND_RTOL up to the larger relation terms; the
    deciding bound less its relation terms to BOUND_RTOL."""
    slack = max(_relation(res), _relation(ref))
    assert len(res.certified_bound) == len(ref.certified_bound)
    for a, r in zip(res.certified_bound, ref.certified_bound):
        assert abs(a - r) <= BOUND_RTOL * r + slack, (a, r, slack)
    np.testing.assert_allclose(res.certified_bound[-1] - _relation(res), ref.certified_bound[-1] - _relation(ref),
                               rtol=BOUND_RTOL)


def _unit_rows(d, n, seed, identical=True):
    b = tkt.random_rhs(d, n, seed=seed, identical=identical).numpy()
    return b / np.linalg.norm(b, axis=1, keepdims=True)


def _problem(d=2, n=48):
    return tkt.laplace(d, n, shift=25.0, device="cpu"), torch.tensor(_unit_rows(d, n, 7))


def _rel_true(op, x, b):
    """‖b − A x‖/‖b‖ by the dense oracle (b of unit rows: ‖b‖ = 1)."""
    b_full = np.array([1.0])
    for s in range(op.d):
        b_full = np.kron(b_full, np.asarray(b[s], np.float64))
    b_norm = float(np.prod(np.linalg.norm(np.asarray(b, np.float64), axis=1)))
    return float(np.linalg.norm(b_full - kron_matvec_dense(op, cp_full(x)))) / b_norm


# ---- twins of tests/test_df64_device_final.py ----

def test_device_final_matches_host_final():
    op, b = _problem()
    cfg = tkt.SolverConfig(kmax=24, tol=1e-10)
    r_host = tkt.solve_deflated(op, b, cfg, m=6, storage="df64", final="host", certify=True)
    r_dev = tkt.solve_deflated(op, b, cfg, m=6, storage="df64", final="device", certify=True)
    assert r_dev.checkpoints == r_host.checkpoints
    np.testing.assert_array_equal(r_dev.certified_bound, r_host.certified_bound)
    xh, xd = r_host.x.factors.numpy(), r_dev.x.factors.numpy()
    np.testing.assert_allclose(xd, xh, rtol=0, atol=1e-12 * np.abs(xh).max())
    assert r_dev.measured_cp_residual is not None
    band = 2.0 * max(r_dev.cp_residual_floor, r_host.cp_residual_floor)
    assert abs(r_dev.measured_cp_residual - r_host.measured_cp_residual) <= band + 1e-12


def test_device_cross_check_vs_dense_oracle():
    op, b = _problem(d=3, n=20)
    res = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=18, tol=1e-9), m=4, storage="df64", final="device",
                             certify=True)
    assert abs(res.measured_cp_residual - _rel_true(op, res.x, b)) <= 4.0 * res.cp_residual_floor + 1e-12


def test_device_cross_check_function_matches_host():
    rng = np.random.default_rng(3)
    op = tkt.laplace(2, 32, shift=10.0, device="cpu")
    X, w, b = rng.standard_normal((2, 32, 3)), rng.standard_normal(3), rng.standard_normal((2, 32))
    host = cp_residual_cross_check_host(op.bands.numpy(), op.offsets, w, X, b)
    dev = cp_residual_cross_check_device(op, torch.tensor(w), torch.tensor(X), torch.tensor(b))
    np.testing.assert_allclose(dev.value, host.value, rtol=1e-10, atol=1e-12 * max(host.value, 1.0))


def test_save_state_false_leaves_cache_untouched(tmp_path):
    op, b = _problem()
    cfg = tkt.SolverConfig(kmax=16, tol=1e-30)
    cache = str(tmp_path / "state.npz")
    tkt.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8], state_cache=cache)
    with open(cache, "rb") as f:
        before = f.read()
    tkt.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8, 16], state_cache=cache, save_state=False)
    with open(cache, "rb") as f:
        assert f.read() == before


def test_fingerprint_rejects_different_problem(tmp_path):
    """Same shapes, m and kmax, another shift: the fingerprint refuses it."""
    op, b = _problem()
    cfg = tkt.SolverConfig(kmax=16, tol=1e-30)
    cache = str(tmp_path / "state.npz")
    tkt.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8], state_cache=cache)
    op2 = tkt.laplace(2, 48, shift=31.0, device="cpu")
    with pytest.raises(ValueError, match="fingerprint|DIFFERENT"):
        tkt.solve_deflated(op2, b, cfg, m=6, storage="df64", checkpoints=[8, 16], state_cache=cache)


def test_df64_distinct_factors_oracle():
    """Distinct factors (a (d, n, m) deflation basis): the bound dominates the
    dense-oracle residual and final='device' agrees."""
    base = tkt.laplace(2, 40, shift=25.0, device="cpu")
    bands = base.bands.numpy().copy()
    bands[1] *= 1.37
    bands[1, np.asarray(base.offsets) == 0, :] += 11.0
    op = tkt.KroneckerSumOperator(torch.tensor(bands), base.offsets, True)
    b = torch.tensor(_unit_rows(2, 40, 9, identical=False))
    cfg = tkt.SolverConfig(kmax=20, tol=1e-10, identical_factors=False)
    res = tkt.solve_deflated(op, b, cfg, m=5, storage="df64", final="host", certify=True)
    assert tkt.deflation_basis(op, 5).U.shape[0] == 2
    rel_true = _rel_true(op, res.x, b)
    assert rel_true <= 1.05 * res.certified_bound[-1] + 1e-15, (rel_true, res.certified_bound)
    rd = tkt.solve_deflated(op, b, cfg, m=5, storage="df64", final="device", certify=True)
    np.testing.assert_array_equal(rd.certified_bound, res.certified_bound)
    xh = res.x.factors.numpy()
    np.testing.assert_allclose(rd.x.factors.numpy(), xh, rtol=0, atol=1e-12 * np.abs(xh).max())


# ---- twins of tests/test_df64_resume.py ----

def _resume_problem():
    return tkt.laplace(2, 64, shift=30.0, device="cpu"), torch.tensor(_unit_rows(2, 64, 5))


def test_df64_resume_bit_exact(tmp_path):
    op, b = _resume_problem()
    cfg = tkt.SolverConfig(kmax=16, tol=1e-30)
    cache = str(tmp_path / "df64_state.npz")
    tkt.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8], state_cache=cache)
    with np.load(cache) as z:
        assert str(z["storage"]) == "df64" and int(z["k_prev"]) == 9
        assert z["Vh_act"].shape == (9 * 2, 64)
    r_resumed = tkt.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8, 16], state_cache=cache)
    r_fresh = tkt.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8, 16])
    assert r_resumed.checkpoints == r_fresh.checkpoints
    assert r_resumed.relative_residual == r_fresh.relative_residual
    assert r_resumed.certified_bound == r_fresh.certified_bound
    assert torch.equal(r_resumed.x.weights, r_fresh.x.weights)
    assert torch.equal(r_resumed.x.factors, r_fresh.x.factors)
    with np.load(cache) as z:
        assert int(z["k_prev"]) == 17


@pytest.mark.slow  # negative-path variants of the fast bit-exact test, as in tests/test_df64_resume.py
def test_df64_resume_rejects_stale_cache(tmp_path):
    op, b = _resume_problem()
    cache = str(tmp_path / "df64_state.npz")
    cfg = tkt.SolverConfig(kmax=16, tol=1e-30)
    tkt.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8], state_cache=cache)
    with pytest.raises(ValueError, match="stale"):
        tkt.solve_deflated(op, b, cfg, m=4, storage="df64", checkpoints=[8], state_cache=cache)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(ValueError, match="stale"):
            tkt.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8], state_cache=cache, project_every=2)


def test_state_cache_still_rejected_for_unsupported_storage(tmp_path):
    op, b = _resume_problem()
    with pytest.raises(ValueError, match="state_cache"):
        tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=16), m=6, storage="segmented",
                           state_cache=str(tmp_path / "x.npz"))


def test_advance_budget_march_bit_exact(tmp_path):
    """Bounded legs: each runs its budget past the cache, saves and returns a
    RUNNING result with x=None; the marched cache completes to the
    uninterrupted solve's deciding bound, estimate and x."""
    op, b = _resume_problem()
    cfg = tkt.SolverConfig(kmax=16, tol=1e-30)
    cache = str(tmp_path / "march.npz")
    kw = dict(m=6, storage="df64", checkpoints=[8, 16])
    r1 = tkt.solve_deflated(op, b, cfg, **kw, state_cache=cache, advance_budget=4)
    assert r1.x is None and r1.niterations == 4 and r1.status == tkt.Status.RUNNING
    with np.load(cache) as z:
        assert int(z["k_prev"]) == 5
    r2 = tkt.solve_deflated(op, b, cfg, **kw, state_cache=cache, advance_budget=7)
    assert r2.x is None and r2.niterations == 11
    r_fin = tkt.solve_deflated(op, b, cfg, **kw, state_cache=cache)
    r_ref = tkt.solve_deflated(op, b, cfg, **kw)
    assert r_fin.certified_bound[-1] == r_ref.certified_bound[-1]
    assert r_fin.relative_residual[-1] == r_ref.relative_residual[-1]
    assert torch.equal(r_fin.x.factors, r_ref.x.factors)


# ---- twins of tests/test_deflate.py's df64 tests ----

def test_df64_storage_matches_full_and_certifies():
    """df64 matches 'full' in the true residual, its cross-check resolves the
    truth, its evidence (the Gram, ρ, the relation terms, the EFT epsilon) is
    at roundoff, and its bound is within 2x of the truth."""
    op, b = _resume_problem()
    cfg = tkt.SolverConfig(kmax=24, tol=1e-12)
    rf = tkt.solve_deflated(op, b, cfg, m=6, storage="full")
    rd = tkt.solve_deflated(op, b, cfg, m=6, storage="df64")
    tf, td = tkt.kron_residual_dense(op, rf.x, b), tkt.kron_residual_dense(op, rd.x, b)
    assert abs(td - tf) / tf < 1e-3
    assert td <= rd.certified_bound[-1] + 1e-12
    assert rd.boundary_drift_max < 1e-9
    assert abs(rd.measured_cp_residual - td) < 1e-3 * td + rd.cp_residual_floor
    assert rd.gram_deviation is not None and rd.gram_deviation < 1e-12
    assert rd.perturbation_rho is not None and rd.perturbation_rho < 1e-8
    assert 0.0 <= rd.relation_dev_term < 1e-10
    assert 0.0 <= rd.relation_eta_term < 1e-10
    assert rd.eft_eps_measured is not None
    assert rd.certified_bound[-1] <= 2.0 * td + 1e-12


@pytest.mark.slow  # a variant of the fast df64 core test, as in tests/test_deflate.py
def test_df64_project_every_strided():
    op, b = _resume_problem()
    cfg = tkt.SolverConfig(kmax=24, tol=1e-12)
    r1 = tkt.solve_deflated(op, b, cfg, m=6, storage="df64")
    with pytest.warns(RuntimeWarning, match="project_every=4"):
        r4 = tkt.solve_deflated(op, b, cfg, m=6, storage="df64", project_every=4)
    t1, t4 = tkt.kron_residual_dense(op, r1.x, b), tkt.kron_residual_dense(op, r4.x, b)
    assert abs(t4 - t1) / t1 < 1e-2
    assert t4 <= r4.certified_bound[-1] + 1e-12
    assert r4.projection_leak is not None


def _perturbed_inputs():
    """tests/test_deflate.py:test_evaluate_host_recorded_inverts_perturbed_operator's inputs."""
    rng = np.random.default_rng(3)
    d, k, m, Kp = 2, 12, 3, 16
    dg, od = np.zeros((d, k + 1)), np.zeros((d, k + 1))
    dg[:, :k] = 5.0 + rng.standard_normal((d, k))
    od[:, 1:k] = 0.5 * np.abs(rng.standard_normal((d, k - 1)))
    beta = np.abs(rng.standard_normal(d)) * 0.0
    lam = np.sort(np.abs(rng.standard_normal((d, m)))) + 0.5
    c = rng.standard_normal((d, m)) * 0.3
    lam_min = float(lam[:, 0].sum())
    lam_tot_max = float(lam[:, -1].sum() + 2 * (dg.max() + 2 * od.max()))
    kappa = lam_tot_max / lam_min
    co = select_bh(torch.tensor(kappa, dtype=torch.float64), 1e-10 / kappa, load_tables())
    omega, alpha, t_mask = (t.numpy() for t in (co.omega, co.alpha, co.t_mask))
    W = np.zeros((d, Kp, Kp), np.float32)
    W[:, :k, :k] = (rng.standard_normal((d, k, k)) * 1e-4).astype(np.float32)
    return (dg, od, np.zeros((d, k + 1)), beta, k, lam, c, 1.0, lam_min, omega, alpha, t_mask, W,
            np.zeros((d, m, Kp), np.float32), np.zeros((d, k + 1)), np.ones(d), np.zeros(d), 1e-20,
            np.full(d, lam_tot_max / d), 0.0)


def test_evaluate_host_recorded_inverts_perturbed_operator():
    """With a recorded W of 1e-4 scale the Fréchet-corrected y drives the
    joint defect (~|W|²) far below the uncorrected one (~|W|)."""
    args = _perturbed_inputs()
    rel_un = df64_core._evaluate_host_recorded(*args, frechet=False)[0]
    rel_co = df64_core._evaluate_host_recorded(*args, frechet=True)[0]
    assert rel_un > 1e-6
    assert rel_co < rel_un / 50.0, (rel_un, rel_co)


# ---- the port against the JAX package ----

CASE = dict(d=2, n=64, shift=30.0, seed=5, m=6, checkpoints=[8, 16, 24], config=dict(kmax=24, tol=1e-12))


@pytest.fixture(scope="module")
def jax_df64(tmp_path_factory):
    """The JAX package's df64 solve of CASE, with its state cache, once per module."""
    q = CASE
    cache = str(tmp_path_factory.mktemp("jax_df64") / "state.npz")
    res = tk.solve_deflated(tk.laplace(q["d"], q["n"], shift=q["shift"]), jnp.asarray(_unit_rows(q["d"], q["n"],
                            q["seed"])), tk.SolverConfig(**q["config"]), m=q["m"], storage="df64",
                            checkpoints=q["checkpoints"], state_cache=cache)
    return res, cache


def _port_case(**kw):
    q = CASE
    op = tkt.laplace(q["d"], q["n"], shift=q["shift"], device="cpu")
    b = torch.tensor(_unit_rows(q["d"], q["n"], q["seed"]))
    return op, b, tkt.solve_deflated(op, b, tkt.SolverConfig(**q["config"]), m=q["m"], storage="df64",
                                     checkpoints=q["checkpoints"], **kw)


def test_df64_solve_matches_jax(tmp_path, jax_df64):
    """Status, steps and checkpoints equal; the recorded α and β to 1e-12
    relative (from both state caches); bounds and estimates to the
    tolerances above; x to 1e-10; both bounds above the dense oracle."""
    ref, ref_cache = jax_df64
    cache = str(tmp_path / "state.npz")
    op, b, res = _port_case(state_cache=cache)
    assert (res.status, res.niterations, res.checkpoints, res.m, res.expsum_rank) == (
        int(ref.status), ref.niterations, ref.checkpoints, ref.m, ref.expsum_rank)
    with np.load(cache) as mine, np.load(ref_cache) as theirs:
        assert set(mine.files) == set(theirs.files) and str(mine["fingerprint"]) == str(theirs["fingerprint"])
        for f in ("dg", "od"):
            np.testing.assert_allclose(mine[f], theirs[f], rtol=TRIDIAG_RTOL, atol=0)
        for f in ("Vh_act", "W", "C"):
            assert mine[f].shape == theirs[f].shape and mine[f].dtype == theirs[f].dtype, f
    _assert_bounds_agree(res, ref)
    np.testing.assert_allclose(res.relative_residual, ref.relative_residual, rtol=EST_RTOL, atol=EST_ATOL)
    np.testing.assert_allclose(res.x.factors.numpy(), np.asarray(ref.x.factors), rtol=0, atol=1e-10)
    oracle = tkt.kron_residual_dense(op, res.x, b)
    assert oracle <= res.certified_bound[-1] and oracle <= ref.certified_bound[-1]


@pytest.mark.parametrize("frechet", [True, False])
def test_evaluate_host_recorded_equals_jax(frechet):
    """The host evaluation is the JAX package's numpy code: equal outputs on
    identical inputs (a recorded W and C of roundoff scale, nonzero dev)."""
    args = list(_perturbed_inputs())
    rng = np.random.default_rng(12)
    args[13] = (rng.standard_normal(args[13].shape) * 1e-9).astype(np.float32)     # C
    args[14] = np.abs(rng.standard_normal(args[14].shape)) * 1e-14                 # dev
    args[16] = np.full(2, 1e-16)                                                   # dev0
    args[19] = 1e-14                                                               # gram_dev
    mine = df64_core._evaluate_host_recorded(*args, frechet=frechet)
    ref = jdf64._evaluate_host_recorded(*args, frechet=frechet)
    assert mine[0] == ref[0] and mine[1] == ref[1] and mine[5] == ref[5]
    for a, r in zip(mine[2:5], ref[2:5]):
        np.testing.assert_array_equal(a, r)


# ---- the card route (df64_core._card_factors, _evaluate_card_recorded) on CPU f64 tensors ----

def _coincident_inputs():
    """_perturbed_inputs' widths with degenerate pairs in both divided
    differences: each T_s two equal uncoupled blocks (every eigenvalue
    double), λ_s holding one of T_s's eigenvalues exactly and another within
    1e-12 of one, a recorded C beside W and a nonzero boundary coupling."""
    from scipy.linalg import eigh_tridiagonal

    rng = np.random.default_rng(5)
    d, k, m, Kp = 2, 12, 3, 16
    dg, od = np.zeros((d, k + 1)), np.zeros((d, k + 1))
    half = 5.0 + rng.standard_normal((d, k // 2))
    dg[:, :k] = np.concatenate([half, half], axis=1)
    off = 0.5 * np.abs(rng.standard_normal((d, k // 2 - 1)))
    od[:, 1:k] = np.concatenate([off, np.zeros((d, 1)), off], axis=1)
    od[:, k] = 0.2
    T = np.stack([eigh_tridiagonal(dg[s, :k], od[s, 1:k])[0] for s in range(d)])
    lam = np.stack([[0.7, T[s, 2], T[s, 7] * (1.0 + 1e-12)] for s in range(d)])
    c = rng.standard_normal((d, m)) * 0.3
    lam_min = float(lam[:, 0].sum())
    lam_tot_max = float(lam[:, -1].sum() + 2 * (dg.max() + 2 * od.max()))
    kappa = lam_tot_max / lam_min
    co = select_bh(torch.tensor(kappa, dtype=torch.float64), 1e-10 / kappa, load_tables())
    omega, alpha, t_mask = (t.numpy() for t in (co.omega, co.alpha, co.t_mask))
    W = np.zeros((d, Kp, Kp), np.float32)
    W[:, :k, :k] = (rng.standard_normal((d, k, k)) * 1e-4).astype(np.float32)
    C = np.zeros((d, m, Kp), np.float32)
    C[:, :, :k] = (rng.standard_normal((d, m, k)) * 1e-4).astype(np.float32)
    return (dg, od, np.zeros((d, k + 1)), od[:, k].copy(), k, lam, c, 1.0, lam_min, omega, alpha, t_mask, W, C,
            np.zeros((d, k + 1)), np.ones(d), np.zeros(d), 1e-20, np.full(d, lam_tot_max / d), 0.0)


def _twin_inputs(case):
    """The host route's arguments and a deflated block's defect e_u: the JAX
    comparison's roundoff-scale C (where the case has none), nonzero dev,
    dev0 and Gram deviation."""
    args = list(_perturbed_inputs() if case == "perturbed" else _coincident_inputs())
    rng = np.random.default_rng(12)
    if case == "perturbed":
        args[13] = (rng.standard_normal(args[13].shape) * 1e-9).astype(np.float32)     # C
    args[14] = np.abs(rng.standard_normal(args[14].shape)) * 1e-14                     # dev
    args[16] = np.full(2, 1e-16)                                                       # dev0
    args[19] = 1e-14                                                                   # gram_dev
    return args, np.abs(rng.standard_normal(args[5].shape)) * 1e-13


@pytest.mark.parametrize("frechet", [True, False])
@pytest.mark.parametrize("case", ["perturbed", "coincident"])
def test_card_route_is_the_host_evaluation(monkeypatch, case, frechet):
    """The card route's torch code on CPU f64 tensors against the host
    route: the certificate's terms and ρ to 1e-10, Yu and Yv to 1e-10 beside
    1e-14 of their largest entry; ρ not below the SVD's σ_max (the host
    route's ρ); the coincident case reaches both sinhc patches with pairs off
    the diagonal. A checkpoint's cheap and Fréchet calls share one
    eigendecomposition a factor and one eigensolver call for ρ."""
    import scipy.linalg

    args, e_u = _twin_inputs(case)
    (dg, od, btil, beta, k, lam, c, b_norm, lam_min, omega, alpha, t_mask, W, C, dev, b0, dev0, eps_elem, lam_g,
     gram_dev) = args
    calls = {"eigh_tridiagonal": 0, "eigvalsh": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(scipy.linalg, "eigh_tridiagonal", counted("eigh_tridiagonal", scipy.linalg.eigh_tridiagonal))
    monkeypatch.setattr(torch.linalg, "eigvalsh", counted("eigvalsh", torch.linalg.eigvalsh))
    patches = []      # (side, degenerate pairs) of each sinhc patch
    real_patch = df64_core._sinhc_patch

    def patch(dY, G, x_row, x_col, e_row, e_col, gam, rows, cols, valid):
        patches.append(("V" if x_row is x_col else "U", int(valid.sum())))
        return real_patch(dY, G, x_row, x_col, e_row, e_col, gam, rows, cols, valid)

    monkeypatch.setattr(df64_core, "_sinhc_patch", patch)
    f = df64_core._card_factors(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (W, C, dg, od, btil, dev)), k,
                                lam, c, b0, lam_min, omega, alpha, t_mask)
    rest = (b_norm, dev, b0, dev0, eps_elem, lam_g, gram_dev)
    cheap = df64_core._evaluate_card_recorded(f, beta, *rest, frechet=False, e_u=e_u)
    fre = df64_core._evaluate_card_recorded(f, beta, *rest, frechet=True, e_u=e_u)
    assert calls == {"eigh_tridiagonal": 2, "eigvalsh": 1}
    got = fre if frechet else cheap
    ref = df64_core._evaluate_host_recorded(*args, frechet=frechet, e_u=e_u)
    for key in ("boundary", "dev_term", "eta_term", "r2_term", "rho"):
        np.testing.assert_allclose(got[5][key], ref[5][key], rtol=1e-10, atol=0, err_msg=key)
    assert got[5]["rho"] >= ref[5]["rho"] > 0.0
    act = np.flatnonzero(t_mask > 0)
    for mine, host in ((got[2], ref[2][:, :, act]), (got[3], ref[3][:, :k, act])):
        assert mine.shape == host.shape
        np.testing.assert_allclose(mine.numpy(), host, rtol=1e-10, atol=1e-14 * np.abs(host).max())
    np.testing.assert_array_equal(got[4], ref[4])
    if case == "coincident":
        # per factor the V patch holds the diagonal and each double eigenvalue's two pairs, the U patch λ_s's
        # two coincidences with a double eigenvalue; the last row of Yv is reached through W alone (T_s's blocks
        # are uncoupled)
        assert (got[5]["boundary"] > 0.0) is frechet
        assert patches == [("V", 2 * k), ("U", 4)] * 2
    else:
        assert patches == [("V", k)] * 2


def test_exact_gram_parts_are_exact():
    """_exact_gram_parts' products of the slices are exact, by rational
    arithmetic, on columns of moderate and of wide dynamic range and a zero
    column; their longdouble sum is JᵀJ within 5·n·δ³·c_i·c_j plus
    2^-61·Σ_p|J_pi||J_pj| (its rounding), which the f64 GEMM's result misses
    (it is rounded to 2^-53 of the entry)."""
    from fractions import Fraction

    rng = np.random.default_rng(4)
    n, P = 300, 5
    J = rng.standard_normal((1, n, P)) * np.exp(rng.uniform(-3.0, 3.0, (1, n, P)))
    J[0, :, 3] *= np.exp(rng.uniform(-20.0, 20.0, n))
    J[0, :, 4] = 0.0
    Jt = torch.from_numpy(J)
    slices = [x[0].numpy() for x in df64_core._gram_slices(Jt)]
    parts = df64_core._exact_gram_parts(Jt)[0].numpy()
    rat = lambda x: Fraction(*x.as_integer_ratio())
    for (a, b), part in zip(((0, 0), (0, 1), (1, 1), (0, 2)), parts):
        for i in range(P):
            for j in range(P):
                assert rat(part[i, j]) == sum(rat(x) * rat(y) for x, y in zip(slices[a][:, i], slices[b][:, j]))
    got, gemm = df64_core._gram_sum(parts[None])[0], J[0].T @ J[0]
    s = (52 + (n - 1).bit_length() + 1) // 2
    c = 2.0 ** np.frexp(np.abs(J[0]).max(axis=0))[1]
    scale = np.abs(J[0]).T @ np.abs(J[0])
    missed = 0
    for i in range(P):
        for j in range(P):
            exact = sum(rat(x) * rat(y) for x, y in zip(J[0, :, i], J[0, :, j]))
            bound = Fraction(5 * n * c[i] * c[j]) * Fraction(2) ** (3 * (s - 53)) + Fraction(scale[i, j]) / 2 ** 61
            assert abs(rat(got[i, j]) - exact) <= bound, (i, j)
            missed += abs(rat(gemm[i, j]) - exact) > bound
    assert missed > P


def test_jax_written_cache_resumes_in_the_port(tmp_path):
    """A cache the JAX package wrote at checkpoint 8 loads in the port, which
    resumes to the JAX uninterrupted run's status and checkpoints, and its
    bounds; the reverse: the port's cache at 8 resumes in the JAX package."""
    q = CASE
    b = _unit_rows(q["d"], q["n"], q["seed"])
    jop, cfg = tk.laplace(q["d"], q["n"], shift=q["shift"]), tk.SolverConfig(kmax=16, tol=1e-30)
    jcache, pcache = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    tk.solve_deflated(jop, jnp.asarray(b), cfg, m=q["m"], storage="df64", checkpoints=[8], state_cache=jcache)
    ref = tk.solve_deflated(jop, jnp.asarray(b), cfg, m=q["m"], storage="df64", checkpoints=[8, 16],
                            state_cache=jcache, save_state=False)
    op = tkt.laplace(q["d"], q["n"], shift=q["shift"], device="cpu")
    pcfg = tkt.SolverConfig(kmax=16, tol=1e-30)
    res = tkt.solve_deflated(op, torch.tensor(b), pcfg, m=q["m"], storage="df64", checkpoints=[8, 16],
                             state_cache=jcache, save_state=False)
    assert (res.status, res.niterations, res.checkpoints) == (int(ref.status), ref.niterations, ref.checkpoints)
    _assert_bounds_agree(res, ref)
    tkt.solve_deflated(op, torch.tensor(b), pcfg, m=q["m"], storage="df64", checkpoints=[8], state_cache=pcache)
    back = tk.solve_deflated(jop, jnp.asarray(b), cfg, m=q["m"], storage="df64", checkpoints=[8, 16],
                             state_cache=pcache, save_state=False)
    assert (int(back.status), back.niterations, back.checkpoints) == (res.status, res.niterations, res.checkpoints)
    _assert_bounds_agree(res, back)


# ---- the certificate's premise ----

def test_recorded_relation_holds_every_step():
    """For every step k and factor s, in longdouble with the operator's own
    bands: ‖A v_{k-1} − (V w_k + U c_k + α v_{k-1} + β_{k-1} v_{k-2} + β_k v_k)‖
    ≤ dev_k + η̂_k, w and c the recorded f32 coefficients, dev_k the recorded
    commit deviation plus the bands' pair rounding (df64_core._band_rounding)
    and the GEMMs' (df64_core._application_rounding), η̂_k the η model of
    _evaluate_host_recorded. The shift is not exact in 48 bits, so the band
    charge is what closes the relation: without it the premise fails."""
    d, n, m, k = 2, 40, 5, 24
    op = tkt.reaction_diffusion(d, n, sigma=1.0 / 3.0, device="cpu")
    basis = tkt.deflation_basis(op, m)
    U64 = torch.tensor(basis.U)
    b_perp = deflation_project(torch.tensor(_unit_rows(d, n, 2)), U64)
    st, _, _ = df64_core._df64_init(b_perp.numpy(), k + 1, m, "cpu")
    Upair = df64_core.pair_value(U64)
    df64_core._df64_advance(*ex.pair_from_f64(op.bands), op.offsets, st, b_perp, Upair, 1, k)

    ld = np.longdouble
    A = tkt.bands_to_dense(op).astype(ld)
    V, W, C = st.V.numpy().astype(ld), st.W.numpy().astype(ld), st.C.numpy().astype(ld)
    dg, od, dev = st.dg.numpy(), st.od.numpy(), st.dev.numpy()
    Up = Upair.numpy().astype(ld)[0]
    eps = df64_core._eft_eps("cpu")
    lam_g = tkt.deflate._gershgorin_per_factor(op)
    band = df64_core._band_rounding(op.bands.numpy(), op.offsets) * df64_core.BAND_CHARGE_SCALE
    gemm = df64_core._application_rounding(st.W.numpy(), st.C.numpy(), k)
    eta_max, band_needed = 0.0, False
    for s in range(d):
        for kk in range(1, k + 1):
            vq = V[kk - 2, s] if kk >= 2 else np.zeros(n, ld)
            rhs = (W[s, :kk, kk - 1] @ V[:kk, s] + Up @ C[s, :, kk - 1] + ld(dg[s, kk - 1]) * V[kk - 1, s]
                   + ld(od[s, kk - 1]) * vq + ld(od[s, kk]) * V[kk, s])
            err = float(np.sqrt(np.sum((A[s] @ V[kk - 1, s] - rhs) ** 2)))
            eta = (8.0 * eps * (lam_g[s] + abs(dg[s, kk - 1]) + od[s, kk - 1] + od[s, kk])
                   + 2.0**-24 * float(np.abs(W[s, :, kk - 1]).sum() + np.abs(C[s, :, kk - 1]).sum()))
            assert err <= dev[s, kk] + band[s] + gemm[s, kk - 1] + eta, (s, kk, err, dev[s, kk], band[s], eta)
            band_needed |= err > dev[s, kk] + gemm[s, kk - 1] + eta
            eta_max = max(eta_max, eta)
    assert band_needed and band.min() > 10.0 * eta_max


@pytest.mark.parametrize("shared", [True, False])
def test_deflation_residual_bounds_the_basis_defect(shared):
    """df64_core._deflation_residual bounds ‖A_s ũ_j − λ_j ũ_j‖ for every
    factor and column, in longdouble with the operator's own bands (not
    exact in 48 bits), ũ_j the stored pair column (shared and distinct
    bases), and within 1e-6 of it beside its own η-model rounding term; the
    defect it measures (the pair rounding of U, amplified by A) is far above
    the η scale."""
    d, n, m = 2, 40, 5
    op = tkt.reaction_diffusion(d, n, sigma=1.0 / 3.0, device="cpu")
    if not shared:
        bands = op.bands.numpy().copy()
        bands[1] *= 1.37
        op = tkt.KroneckerSumOperator(torch.tensor(bands), op.offsets, True)
    basis = tkt.deflation_basis(op, m)
    assert basis.U.shape[0] == (1 if shared else d)
    Upair = df64_core.pair_value(torch.tensor(basis.U))
    eps = df64_core._eft_eps("cpu")
    lam_g = tkt.deflate._gershgorin_per_factor(op)
    e_u = df64_core._deflation_residual(op.bands, op.offsets, Upair, basis.lam, eps, lam_g)
    ld = np.longdouble
    A = tkt.bands_to_dense(op).astype(ld)
    Up = Upair.numpy().astype(ld)
    worst = 0.0
    for s in range(d):
        Us = Up[0 if shared else s]
        for j in range(m):
            err = float(np.sqrt(np.sum((A[s] @ Us[:, j] - ld(basis.lam[s, j]) * Us[:, j]) ** 2)))
            rounding = 8.0 * eps * (lam_g[s] + abs(basis.lam[s, j]))      # the charge's η-model part
            assert err <= e_u[s, j] <= err * (1.0 + 1e-6) + 1.01 * rounding, (s, j, err, e_u[s, j], rounding)
            worst = max(worst, err / (8.0 * eps * lam_g[s]))
    assert worst > 50.0


@pytest.mark.parametrize("charged", [True, False])
def test_rotated_basis_defect_is_charged(charged, monkeypatch):
    """A deflation basis that is orthonormal but not invariant (each
    eigenvector turned by 1e-7 toward another), b with a large share in its
    span: the evaluation takes A Ũ = Ũ Λ, so the bound must carry the
    measured defect (df64_core._deflation_residual). With it the bound
    dominates the dense oracle; with the defect's charge set to 0 the oracle
    exceeds the bound tenfold."""
    d, n, m = 2, 40, 6
    op = tkt.laplace(d, n, shift=25.0, device="cpu")
    lam, Q = np.linalg.eigh(tkt.bands_to_dense(op)[0])
    theta = 1e-7
    U = Q[:, :m] * np.cos(theta) + Q[:, m:2 * m] * np.sin(theta)
    basis = tkt.DeflationBasis(U=U[None], lam=np.tile(lam[:m], (d, 1)))
    if not charged:
        monkeypatch.setattr(tkt.deflate, "_deflation_residual", lambda *a, **k: np.zeros((d, m)))
    b = _unit_rows(d, n, 4) + 3.0 * U[:, 0]
    b = torch.tensor(b / np.linalg.norm(b, axis=1, keepdims=True))
    res = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=32, tol=1e-10), basis=basis, storage="df64",
                             final="host")
    rel_true = _rel_true(op, res.x, b)
    assert rel_true > 1e-8            # the defect's share of the residual, far above the solve's own
    if charged:
        assert rel_true <= res.certified_bound[-1], (rel_true, res.certified_bound)
    else:
        assert rel_true > 10.0 * res.certified_bound[-1], (rel_true, res.certified_bound)


def test_final_auto_is_host_on_the_cpu(monkeypatch):
    """final='auto' resolves to 'device' on a CUDA operator and to 'host'
    otherwise; on a CPU operator the df64 solve then never calls the device
    cross-check and equals final='host'."""
    assert tkt.deflate._resolve_final("auto", torch.device("cuda")) == "device"
    assert tkt.deflate._resolve_final("auto", torch.device("cpu")) == "host"
    assert tkt.deflate._resolve_final("device", torch.device("cpu")) == "device"
    with pytest.raises(ValueError, match="final must be"):
        tkt.deflate._resolve_final("card", torch.device("cpu"))
    op, b = _problem(d=2, n=24)
    cfg = tkt.SolverConfig(kmax=8, tol=1e-30)
    rh = tkt.solve_deflated(op, b, cfg, m=4, storage="df64", final="host")

    def refuse(*args, **kwargs):
        raise AssertionError("final='auto' ran the device cross-check on a CPU operator")

    monkeypatch.setattr(tkt.deflate, "cp_residual_cross_check_device", refuse)
    ra = tkt.solve_deflated(op, b, cfg, m=4, storage="df64")
    assert ra.certified_bound == rh.certified_bound and ra.measured_cp_residual == rh.measured_cp_residual
    assert torch.equal(ra.x.factors, rh.x.factors)


def test_df64_option_validation():
    """mesh= with df64 takes comm='gspmd' only, as in the JAX package
    (deflate.py:847-852): comm='ring' raises naming 'gspmd'; final='device'
    and the df64 leg options on another storage are refused."""
    from tensorkrylov_tpu_torch.parallel import make_mesh

    op, b = _problem()
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="comm='gspmd'"):
        tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=8), m=2, storage="df64", mesh=mesh, comm="ring")
    with pytest.raises(ValueError, match="final='device'"):
        tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=8), m=2, storage="full", final="device")
    for kw in (dict(advance_budget=4), dict(save_every=8)):
        with pytest.raises(ValueError, match="storage='df64' options"):
            tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=8), m=2, storage="twopass", **kw)
