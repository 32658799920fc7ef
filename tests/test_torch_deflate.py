"""The port's deflated solver (deflate.py, deflate_light.py, the deflation
projection of ops/orth.py) on the CPU: against the JAX package's on the same
numpy inputs, and against the dense oracle (tests/test_deflate.py's cases;
the twins of its three df64 tests are in tests/test_torch_df64.py). The JAX
package's slow tests have fast twins here that run the port alone; the JAX
side of each compared case runs once per module."""
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu import deflate as jdeflate
from tensorkrylov_tpu.coeffs.tables import load_tables as jload_tables, select_bh as jselect_bh
from tensorkrylov_tpu.types import KroneckerSumOperator as JOperator
from tensorkrylov_tpu_torch import deflate, deflate_light
from tensorkrylov_tpu_torch.coeffs.tables import load_tables, select_bh
from tensorkrylov_tpu_torch.ops.orth import deflation_project

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)

# The certified bound (the exp-sum sup plus the measured boundary, a sum of
# positives) agrees to rtol 1e-10; where it is ~1e-7 its boundary row is
# small against y and rounds to eps·‖y‖ absolute, so atol 1e-15 beside it.
# The estimate's compressed part ‖Hy‖² − 2⟨Hy, b̃⟩ + ‖b̃‖² cancels to the
# eps·‖b̃‖² level, and the two packages' sums round apart there: estimates
# agree to that floor, 2√eps relative to ‖b‖ (DESIGN.md §6), beside rtol 1e-10.
BOUND_RTOL, BOUND_ATOL = 1e-10, 1e-15
EST_RTOL, EST_ATOL = 1e-10, 2.0 * math.sqrt(np.finfo(np.float64).eps)
X_ATOL = 1e-10


def _distinct_shifted(pkg, d, n, base_shift=50.0):
    """tests/test_deflate.py's distinct factors: the shifted Laplacian with
    factor s's diagonal raised by 5·s."""
    bands = _laplace(tk, d, n, base_shift).bands
    bands = np.asarray(bands).copy()
    for s in range(d):
        bands[s, 1, :] += 5.0 * s
    if pkg is tk:
        return JOperator(jnp.asarray(bands), (-1, 0, 1), True)
    return tkt.KroneckerSumOperator(torch.tensor(bands), (-1, 0, 1), True)


def _laplace(pkg, d, n, shift):
    return pkg.laplace(d, n, shift=shift) if pkg is tk else pkg.laplace(d, n, shift=shift, device="cpu")


def _unit_rows(d, n, seed):
    b = np.asarray(tk.random_rhs(d, n, seed=seed))
    return b / np.linalg.norm(b, axis=1, keepdims=True)


# name: (operator of a package, b, config fields, solve_deflated keywords); tests/test_deflate.py's cases
CASES = {
    "oracle": (lambda p: _laplace(p, 3, 30, 50.0), np.asarray(tk.random_rhs(3, 30, seed=7)),
               dict(kmax=30, tol=1e-7), dict(m=6, checkpoints=[8, 16, 24, 30])),
    "distinct": (lambda p: _distinct_shifted(p, 3, 30), np.asarray(tk.random_rhs(3, 30, seed=3)),
                 dict(kmax=30, tol=1e-7), dict(m=5, checkpoints=[10, 20, 30])),
    "host": (lambda p: _laplace(p, 3, 30, 50.0), np.asarray(tk.random_rhs(3, 30, seed=7)),
             dict(kmax=30, tol=1e-7, eigh_impl="host"), dict(m=6, checkpoints=[8, 16, 24, 30])),
    "twopass": (lambda p: _laplace(p, 2, 64, 30.0), _unit_rows(2, 64, 5), dict(kmax=24, tol=1e-12),
                dict(m=6, storage="twopass", checkpoints=[8, 16, 24])),
    "segmented": (lambda p: _laplace(p, 2, 64, 30.0), _unit_rows(2, 64, 5), dict(kmax=24, tol=1e-12),
                  dict(m=6, storage="segmented", segment=8)),
    "twopass_host_distinct": (lambda p: _distinct_shifted(p, 2, 64, 30.0), _unit_rows(2, 64, 5),
                              dict(kmax=24, tol=1e-12, eigh_impl="host"),
                              dict(m=6, storage="twopass", checkpoints=[8, 16, 24])),
    "stride": (lambda p: _laplace(p, 2, 64, 30.0), _unit_rows(2, 64, 5), dict(kmax=20, tol=1e-12),
               dict(m=6, storage="twopass", project_every=8)),
}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's solve of a case, computed once per module; the
    twopass case writes its state cache (for the fingerprint test)."""
    cache, root = {}, tmp_path_factory.mktemp("jax_state")

    def run(name):
        if name not in cache:
            make, b, fields, kw = CASES[name]
            extra = dict(state_cache=str(root / "twopass.npz")) if name == "twopass" else {}
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                cache[name] = tk.solve_deflated(make(tk), b, tk.SolverConfig(**fields), **kw, **extra)
        return cache[name]

    run.state_cache = root / "twopass.npz"
    return run


def _port(name, **extra):
    make, b, fields, kw = CASES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return tkt.solve_deflated(make(tkt), torch.tensor(b), tkt.SolverConfig(**fields), **{**kw, **extra})


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_deflated_matches_jax(name, jax_run):
    """Status, steps and checkpoints equal; bounds, estimates, the spectral
    interval and the exp-sum sup to the tolerances above; x's factors to
    1e-10; the telemetry of the storage present on both sides; and the dense
    oracle below the certified bound."""
    ref, res = jax_run(name), _port(name)
    assert (res.status, res.niterations, res.checkpoints, res.m, res.expsum_rank) == (
        int(ref.status), ref.niterations, ref.checkpoints, ref.m, ref.expsum_rank)
    np.testing.assert_allclose(res.certified_bound, ref.certified_bound, rtol=BOUND_RTOL, atol=BOUND_ATOL)
    np.testing.assert_allclose(res.relative_residual, ref.relative_residual, rtol=EST_RTOL, atol=EST_ATOL)
    np.testing.assert_allclose([res.lambda_min, res.lambda_max, res.expsum_sup],
                               [ref.lambda_min, ref.lambda_max, ref.expsum_sup], rtol=1e-10)
    np.testing.assert_allclose(res.x.factors.numpy(), np.asarray(ref.x.factors), rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(res.x.weights.numpy(), np.asarray(ref.x.weights), rtol=1e-12)
    for f in ("projection_leak", "boundary_drift_max", "pass2_gram_max", "pass2_beta_rel_dev",
              "cp_residual_floor"):
        assert (getattr(res, f) is None) == (getattr(ref, f) is None), f
    np.testing.assert_allclose(res.cp_residual_floor, ref.cp_residual_floor, rtol=1e-6)
    make, b, _, _ = CASES[name]
    assert tkt.kron_residual_dense(make(tkt), res.x, b) <= res.certified_bound[-1] + 1e-14


def test_deflation_basis_tridiag_eigenpairs():
    op = tkt.laplace(3, 30, shift=7.0, device="cpu")
    basis = tkt.deflation_basis(op, 6)
    ref = tk.deflation_basis(tk.laplace(3, 30, shift=7.0), 6)
    assert basis.U.shape == (1, 30, 6) and isinstance(basis.U, np.ndarray)
    np.testing.assert_allclose(basis.U, np.asarray(ref.U), rtol=0, atol=1e-12)
    np.testing.assert_allclose(basis.lam, np.asarray(ref.lam), rtol=1e-12)
    U, lam, A = basis.U[0], basis.lam, tkt.bands_to_dense(op)[0]
    assert np.abs(U.T @ U - np.eye(6)).max() < 1e-12
    assert np.abs(A @ U - U * lam[0][None, :]).max() < 1e-9
    np.testing.assert_allclose(lam[0], np.linalg.eigvalsh(A)[:6], rtol=1e-10)
    assert tkt.deflation_basis(op, 6, dtype=torch.float32).U.dtype == np.float32


def test_deflation_basis_distinct_and_dense_fallback():
    op = _distinct_shifted(tkt, 3, 20)
    basis, ref = tkt.deflation_basis(op, 4), tk.deflation_basis(_distinct_shifted(tk, 3, 20), 4)
    assert basis.U.shape == (3, 20, 4)
    np.testing.assert_allclose(basis.lam, np.asarray(ref.lam), rtol=1e-12)
    np.testing.assert_allclose(basis.U, np.asarray(ref.U), rtol=0, atol=1e-12)
    A = tkt.bands_to_dense(op)
    for s in range(3):
        np.testing.assert_allclose(basis.lam[s], np.linalg.eigvalsh(A[s])[:4], rtol=1e-10)

    # pentadiagonal SPD → the dense-eigh branch
    n = 16
    T = (np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)
         + np.diag(np.full(n - 2, -0.3), 2) + np.diag(np.full(n - 2, -0.3), -2))
    b5 = tkt.deflation_basis(tkt.operator_from_dense_factors(np.stack([T] * 2), symmetric=True, device="cpu"), 3)
    r5 = tk.deflation_basis(tk.operator_from_dense_factors(np.stack([T] * 2), symmetric=True), 3)
    np.testing.assert_allclose(b5.lam[0], np.linalg.eigvalsh(T)[:3], rtol=1e-10)
    np.testing.assert_allclose(b5.lam, np.asarray(r5.lam), rtol=1e-12)
    np.testing.assert_allclose(np.abs(b5.U), np.abs(np.asarray(r5.U)), rtol=0, atol=1e-12)


def test_deflation_basis_toeplitz_analytic_branches():
    """The analytic sin-eigenvector path for both off-diagonal signs, and the
    LAPACK path for a non-constant tridiagonal, against eigh and JAX."""
    from scipy.linalg import eigh_tridiagonal

    n, m = 37, 6
    for a, b in ((2.0 * 38.0**2 + 5.0, -(38.0**2)), (3.0, 1.7)):
        lam, U = deflate._toeplitz_lowest_m(n, m, a, b)
        jlam, jU = jdeflate._toeplitz_lowest_m(n, m, a, b)
        np.testing.assert_array_equal(lam, jlam)
        np.testing.assert_array_equal(U, jU)
        w, V = eigh_tridiagonal(np.full(n, a), np.full(n - 1, b), select="i", select_range=(0, m - 1))
        np.testing.assert_allclose(lam, w, rtol=1e-13)
        assert np.abs(np.abs(U.T @ V) - np.eye(m)).max() < 1e-11
        assert np.all(np.diff(lam) > 0)

    diag = 100.0 + np.linspace(0.0, 9.0, n)
    T = np.diag(diag) + np.diag(np.full(n - 1, -3.0), 1) + np.diag(np.full(n - 1, -3.0), -1)
    basis = tkt.deflation_basis(tkt.operator_from_dense_factors(T[None], symmetric=True, device="cpu"), m)
    np.testing.assert_allclose(basis.lam[0], np.linalg.eigvalsh(T)[:m], rtol=1e-10)
    ref = tk.deflation_basis(tk.operator_from_dense_factors(T[None], symmetric=True), m)
    np.testing.assert_array_equal(basis.lam, np.asarray(ref.lam))


def test_tridiag_parts_plus_band_only():
    """offsets (0, +1) give the basis of the (-1, 0) storage; disagreeing
    doubly stored bands are refused."""
    n = 18
    rng = np.random.default_rng(3)
    diag = 8.0 + rng.uniform(0.5, 1.0, n)
    e = -rng.uniform(0.2, 0.4, n - 1)
    lo = np.zeros((1, 2, n)); lo[0, 0] = diag; lo[0, 1, 1:] = e
    hi = np.zeros((1, 2, n)); hi[0, 0] = diag; hi[0, 1, :-1] = e
    d_lo, e_lo = deflate._tridiag_parts(lo, (0, -1))
    d_hi, e_hi = deflate._tridiag_parts(hi, (0, 1))
    np.testing.assert_array_equal(d_lo, d_hi)
    np.testing.assert_array_equal(e_lo, e_hi)
    for got, ref in zip(deflate._tridiag_parts(hi, (0, 1)), jdeflate._tridiag_parts(hi, (0, 1))):
        np.testing.assert_array_equal(got, ref)
    basis = tkt.deflation_basis(tkt.KroneckerSumOperator(torch.tensor(hi), (0, 1), True), 4)
    A = np.diag(diag) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(basis.lam[0], np.linalg.eigvalsh(A)[:4], rtol=1e-10)
    bad = np.zeros((1, 3, n)); bad[0, 0] = diag
    bad[0, 1, 1:] = e; bad[0, 2, :-1] = 2.0 * e
    with pytest.raises(ValueError, match="disagree"):
        deflate._tridiag_parts(bad, (0, -1, 1))


def test_expsum_sup_error_matches_jax_and_table_scale():
    """sup|1 − x g(x)| on [1, κ] is ~ ε·κ for the selected table row, and
    equals the JAX package's to 1e-14."""
    kappa = 1e3
    coeffs = select_bh(torch.tensor(kappa, dtype=torch.float64), 1e-10, load_tables())
    sup = deflate.expsum_sup_error(coeffs.omega, coeffs.alpha, kappa)
    err = float(coeffs.err)
    assert err * 0.5 <= sup <= err * kappa * 1.2
    jc = jselect_bh(jnp.asarray(kappa), 1e-10, jload_tables())
    np.testing.assert_allclose(sup, jdeflate.expsum_sup_error(jc.omega, jc.alpha, kappa), rtol=1e-14)


def _recorded_state(op, b, m, k, reorth="never"):
    """Run k deflated steps of the port on (op, b): (state, b⊥, U (torch), c, lam)."""
    basis = tkt.deflation_basis(op, m)
    U = torch.tensor(basis.U)
    b = torch.tensor(b)
    c = b @ U[0] if U.shape[0] == 1 else torch.bmm(b[:, None, :], U)[:, 0]
    b_perp = deflation_project(b, U)
    st = deflate_light._init_state(b_perp, k + 1)
    V = torch.zeros((k + 1,) + tuple(b.shape), dtype=b.dtype)
    V[0] = st.vp
    deflate_light._advance(op, st, b_perp, U, 1, k + 1, V=V, reorth=reorth)
    return st, V, U, c, torch.tensor(basis.lam)


def test_host_evaluate_matches_device():
    """eigh_impl='host' (numpy/longdouble checkpoint algebra) against the
    device evaluate on one recorded state, both packages' on the same inputs;
    then both paths through the solve (tests/test_deflate.py's case): bounds
    tightly, estimates to the f64 floor, the dense oracle below the bound."""
    op = tkt.reaction_diffusion(3, 36, sigma=500.0, device="cpu")
    b = _unit_rows(3, 36, 3)
    k = 16
    st, _, _, c, lam = _recorded_state(op, b, 8, k)
    coeffs = select_bh(torch.tensor(1e3, dtype=torch.float64), 1e-12, load_tables())
    lam_min, b_norm = float(lam[:, 0].sum()), 1.0
    args = (st.dg, st.od, st.btil, st.od[:, k], k, lam, c, b_norm, lam_min, coeffs.omega, coeffs.alpha,
            coeffs.t_mask)
    dev = deflate._evaluate(*args)
    host = deflate._evaluate_host(*(a.numpy() if torch.is_tensor(a) else a for a in args))
    jdev = jdeflate._evaluate(*(jnp.asarray(a.numpy()) if torch.is_tensor(a) else a for a in args[:4]),
                              jnp.asarray(k), *(jnp.asarray(a.numpy()) if torch.is_tensor(a) else jnp.asarray(a)
                                                for a in args[5:]))
    jhost = jdeflate._evaluate_host(*(a.numpy() if torch.is_tensor(a) else a for a in args))
    for got in (host, jdev, jhost):
        np.testing.assert_allclose(float(got[1]), float(dev[1]), rtol=1e-6, atol=1e-28)   # boundary²
        np.testing.assert_allclose(float(got[0]), float(dev[0]), rtol=1e-4, atol=1e-7)    # estimate
        for a, r in zip(got[2:], dev[2:]):                                                 # Yu, Yv, weights
            np.testing.assert_allclose(np.asarray(a), r.numpy(), rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(host[0], jhost[0], rtol=1e-12)

    cks, basis = [8, 16, 36], tkt.deflation_basis(op, 8)
    rd = tkt.solve_deflated(op, torch.tensor(b), tkt.SolverConfig(kmax=36, tol=1e-9, eigh_impl="dense"),
                            basis=basis, checkpoints=cks)
    rh = tkt.solve_deflated(op, torch.tensor(b), tkt.SolverConfig(kmax=36, tol=1e-9, eigh_impl="host"),
                            basis=basis, checkpoints=cks)
    assert rd.converged and rh.converged
    for a, h in zip(rd.certified_bound, rh.certified_bound):
        assert abs(a - h) <= 1e-6 * a + 1e-14
    for a, h in zip(rd.relative_residual, rh.relative_residual):
        assert abs(a - h) <= 1e-4 * max(a, h) + 1e-7
    assert tkt.kron_residual_dense(op, rh.x, b) <= rh.certified_bound[-1] + 1e-12


def test_advance_reorth_always_orthogonalizes():
    """orth='lanczos_reorth' runs the CGS sweep in the deflated step."""
    op = tkt.laplace(2, 40, shift=0.1, device="cpu")   # κ ~ 7e2: Ritz pairs converge
    b = np.asarray(tk.random_rhs(2, 40, seed=5))
    k, grams = 30, {}
    for mode in ("never", "always"):
        _, V, _, _, _ = _recorded_state(op, b, 2, k, reorth=mode)
        Vk = V[:k].transpose(0, 1)
        grams[mode] = float((torch.einsum("dkn,djn->dkj", Vk, Vk) - torch.eye(k)[None]).abs().max())
    assert grams["always"] < 1e-13
    assert grams["always"] < grams["never"] / 10.0


def test_state_cache_fingerprint_equals_jax(tmp_path, jax_run):
    """The port writes np.savez with the JAX package's field names, and its
    problem fingerprint is the JAX package's for the same problem."""
    jax_run("twopass")
    make, b, fields, kw = CASES["twopass"]
    path = str(tmp_path / "state.npz")
    tkt.solve_deflated(make(tkt), torch.tensor(b), tkt.SolverConfig(**fields), **kw, state_cache=path)
    with np.load(path) as mine, np.load(jax_run.state_cache) as ref:
        assert str(mine["fingerprint"]) == str(ref["fingerprint"])
        assert set(ref.files) == set(mine.files)
        assert int(mine["k_prev"]) == int(ref["k_prev"])
        np.testing.assert_allclose(mine["od"], ref["od"], rtol=1e-12)
