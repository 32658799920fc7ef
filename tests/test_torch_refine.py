"""The port's CP layer (utils/cp.py) and restarted refinement (refine.py) on
the CPU: against the JAX package on the same numpy inputs and the dense
Kronecker oracles (tests/test_refine.py's cases)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu.types import CPTensor as JCP
from tensorkrylov_tpu.utils import cp as jcp
from tensorkrylov_tpu_torch.types import CPTensor
from tensorkrylov_tpu_torch.utils import cp

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)

RTOL = 1e-12  # f64 CP algebra, other BLAS call orders


def _pair(w, F):
    """The same CP tensor in both packages."""
    return JCP(jnp.asarray(w), jnp.asarray(F)), CPTensor(torch.tensor(w), torch.tensor(F))


def _rand_cp(seed, d=3, n=10, t=4):
    rng = np.random.default_rng(seed)
    return _pair(rng.standard_normal(t), rng.standard_normal((d, n, t)))


def _normalized_rhs(d, n, seed):
    b = tk.random_rhs(d, n, seed=seed)
    return np.asarray(b / jnp.linalg.norm(b, axis=1, keepdims=True))


def _close(got: CPTensor, ref, rtol=RTOL):
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights), rtol=rtol)
    np.testing.assert_allclose(got.factors.numpy(), np.asarray(ref.factors), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(ref.factors)).max())


def test_kron_apply_cp_matches_jax_and_dense():
    jx, x = _rand_cp(0)
    ax = tkt.kron_apply_cp(tkt.laplace(3, 10, device="cpu"), x)
    assert ax.rank == 3 * 4
    _close(ax, tk.kron_apply_cp(tk.laplace(3, 10), jx))
    ref = tkt.kron_matvec_dense(tkt.laplace(3, 10, device="cpu"), tkt.cp_full(x))
    np.testing.assert_allclose(tkt.cp_full(ax), ref, rtol=1e-12, atol=1e-9 * np.abs(ref).max())


def test_cp_axpy_and_compress_match_jax():
    (jx, x), (jy, y) = _rand_cp(1), _rand_cp(2)
    _close(tkt.cp_axpy(-0.5, x, y), tk.cp_axpy(-0.5, jx, jy))
    w = np.array([3.0, 0.0, -1e-14, 2.0, 0.0])
    F = np.random.default_rng(3).standard_normal((2, 6, 5))
    jz, z = _pair(w, F)
    for rel_tol in (0.0, 1e-12, 0.9):
        _close(cp.cp_compress(z, rel_tol), jcp.cp_compress(jz, rel_tol))
    jzero, zero = _pair(np.zeros(3), F[:, :, :3])  # nothing above the threshold: the largest |w| stay
    _close(cp.cp_compress(zero, 0.0), jcp.cp_compress(jzero, 0.0))


@pytest.mark.parametrize("iters", [1, 10])
def test_cp_round_matches_jax(iters):
    rng = np.random.default_rng(4)
    d, n, T = 3, 12, 9
    w = rng.standard_normal(T)
    w[4] = w[1]  # a tie in |w|: the stable sort keeps the earlier term
    jx, x = _pair(w, rng.standard_normal((d, n, T)))
    got, ref = tkt.cp_round(x, 4, iters=iters), tk.cp_round(jx, 4, iters=iters)
    full, jfull = tkt.cp_full(got), np.asarray(tk.cp_full(ref))
    assert np.abs(full - jfull).max() <= 1e-10 * np.abs(jfull).max()
    np.testing.assert_allclose(np.abs(got.weights.numpy()), np.abs(np.asarray(ref.weights)), rtol=1e-10)
    assert tkt.cp_round(x, 9) is x


def test_cp_round_exact_rank_recovery():
    """tests/test_refine.py's case: a rank-3 tensor padded with three
    1e-13-weight terms rounds back to it (floor: the default ridge)."""
    rng = np.random.default_rng(1)
    d, n = 3, 12
    F = rng.standard_normal((d, n, 3))
    w = np.array([3.0, 2.0, 1.0])
    padded = CPTensor(torch.tensor(np.r_[w, 1e-13 * np.ones(3)]),
                      torch.tensor(np.concatenate([F, rng.standard_normal((d, n, 3))], axis=2)))
    y = tkt.cp_round(padded, 3, iters=20)
    exact = tkt.cp_full(CPTensor(torch.tensor(w), torch.tensor(F)))
    assert np.linalg.norm(tkt.cp_full(y) - exact) / np.linalg.norm(exact) < 1e-8


def test_cp_dot_accurate_matches_jax():
    (jx, x), (jy, y) = _rand_cp(5), _rand_cp(6)
    np.testing.assert_allclose(cp.cp_dot_accurate(x, y), jcp.cp_dot_accurate(jx, jy), rtol=RTOL)
    np.testing.assert_allclose(cp.cp_norm_accurate(x), jcp.cp_norm_accurate(jx), rtol=RTOL)
    np.testing.assert_allclose(cp.cp_norm_accurate(x), float(tkt.cp_norm(x)), rtol=1e-12)


def _cross_check_inputs(R):
    rng = np.random.default_rng(7 + R)
    d, n, t = 3, 20, 5
    b = rng.standard_normal((d, n)) if R == 1 else rng.standard_normal((R, d, n))
    return tk.laplace(d, n), tkt.laplace(d, n, device="cpu"), rng.standard_normal(t), rng.standard_normal((d, n, t)), b


def _dense_residual(op, w, X, b):
    bs = [b] if b.ndim == 2 else list(b)
    bfull = 0
    for br in bs:
        v = np.array([1.0])
        for s in range(br.shape[0]):
            v = np.kron(v, br[s])
        bfull = bfull + v
    x = tkt.cp_full(CPTensor(torch.tensor(w), torch.tensor(X)))
    return np.linalg.norm(bfull - tkt.kron_matvec_dense(op, x))


@pytest.mark.parametrize("form", ["host", "cross_check", "norm_accurate", "host_rankR", "device", "device_rankR"])
def test_residual_cross_checks_match_jax(form):
    """Each cross-check's value against the JAX package's (to 1e-12) and the
    dense oracle; the floors equal, except the device form's, which charges
    longdouble eps on its compensated Gram where the JAX package charges 1e-15
    on its f32-pair GEMM."""
    R = 2 if form.endswith("rankR") else 1
    jop, op, w, X, b = _cross_check_inputs(R)
    bands = np.asarray(jop.bands)
    if form == "host":
        got, ref = (cp.cp_residual_cross_check_host(bands, op.offsets, w, X, b),
                    jcp.cp_residual_cross_check_host(bands, jop.offsets, w, X, b))
    elif form == "cross_check":
        got = cp.cp_residual_cross_check(op, CPTensor(torch.tensor(w), torch.tensor(X)), torch.tensor(b))
        ref = jcp.cp_residual_cross_check(jop, JCP(jnp.asarray(w), jnp.asarray(X)), b)
    elif form == "norm_accurate":
        got = cp.cp_residual_norm_accurate(op, CPTensor(torch.tensor(w), torch.tensor(X)), torch.tensor(b))
        ref = jcp.cp_residual_norm_accurate(jop, JCP(jnp.asarray(w), jnp.asarray(X)), b)
        np.testing.assert_allclose(got, ref, rtol=RTOL)
        np.testing.assert_allclose(got, _dense_residual(op, w, X, b), rtol=1e-10)
        return
    elif form == "host_rankR":
        got, ref = (cp.cp_residual_cross_check_host_rankR(bands, op.offsets, w, X, b),
                    jcp.cp_residual_cross_check_host_rankR(bands, jop.offsets, w, X, b))
    else:
        got = cp.cp_residual_cross_check_device(op, torch.tensor(w), torch.tensor(X), torch.tensor(b))
        ref = jcp.cp_residual_cross_check_device(jop, w, jnp.asarray(X), jnp.asarray(b))
    np.testing.assert_allclose(got.value, ref.value, rtol=RTOL)
    np.testing.assert_allclose(got.value, _dense_residual(op, w, X, b), rtol=1e-10)
    scale = np.sqrt(np.finfo(np.longdouble).eps / 1e-15) if form.startswith("device") else 1.0
    np.testing.assert_allclose(got.floor, ref.floor * scale, rtol=1e-10)
    assert got.value > got.floor and "floor" in got.interpret()


def test_host_spmv_bands_matches_jax():
    jop, op, _, X, _ = _cross_check_inputs(1)
    bands = np.asarray(jop.bands)
    np.testing.assert_array_equal(cp.host_spmv_bands(bands, op.offsets, X), jcp.host_spmv_bands(bands, jop.offsets, X))


def test_cp_residual_matches_dense_and_jax():
    """tests/test_refine.py's cp_residual case: the CP residual of a
    10-step solve, against the dense oracle (rtol 1e-6, its cancellation)."""
    b = _normalized_rhs(3, 20, 2)
    op = tkt.laplace(3, 20, device="cpu")
    res = tkt.solve(op, torch.tensor(b), tkt.SolverConfig(kmax=10, tol=1e-30))
    r = tkt.cp_residual(op, res.x, torch.tensor(b))
    assert r.rank == 1 + 3 * res.x.rank
    np.testing.assert_allclose(float(tkt.cp_norm(r)), tkt.kron_residual_dense(op, res.x, b), rtol=1e-6)
    jr = tk.cp_residual(tk.laplace(3, 20), JCP(jnp.asarray(res.x.weights.numpy()), jnp.asarray(res.x.factors.numpy())),
                        b)
    _close(r, jr)


REFINED = {  # tests/test_refine.py's cases: (d, n, seed, config, solve_refined keywords, tol of the dense check)
    "beats_single_shot": (3, 32, 3, dict(kmax=10, tol=1e-5), dict(max_restarts=5, residual_rank=4, inner_tol=1e-4),
                          1e-5),
    "solution_rank": (3, 32, 4, dict(kmax=12, tol=1e-3),
                      dict(max_restarts=4, residual_rank=4, solution_rank=24, inner_tol=1e-3), 1e-3),
}


def _refined(name, pkg, **kw):
    d, n, seed, cfg, kwargs, _ = REFINED[name]
    b = _normalized_rhs(d, n, seed)
    op = pkg.laplace(d, n, **kw)
    return op, b, pkg.solve_refined(op, torch.tensor(b) if pkg is tkt else b, pkg.SolverConfig(**cfg), **kwargs)


@pytest.mark.parametrize("name", sorted(REFINED))
def test_solve_refined_dense_oracle(name):
    """Converged from a kmax too small for one shot; the dense residual below
    tol; the history strictly decreasing; the rank bound kept."""
    op, b, ref = _refined(name, tkt, device="cpu")
    tol = REFINED[name][5]
    assert ref.converged, ref.residual_history
    assert ref.true_relative_residual < tol and tkt.kron_residual_dense(op, ref.x, b) < tol
    h = ref.residual_history
    assert all(a > c for a, c in zip(h, h[1:])) and len(ref.rep_condition) == len(h)
    assert ref.cycles == len(ref.inner_iterations)
    if name == "beats_single_shot":
        one_shot = tkt.solve(op, torch.tensor(b), tkt.SolverConfig(**REFINED[name][3]))
        assert one_shot.status != tkt.Status.CONVERGED and h[-1] < h[0] * 1e-3
    else:
        assert ref.x.rank <= 24


@pytest.mark.slow  # its JAX twins are marked slow in tests/test_refine.py
@pytest.mark.parametrize("name", sorted(REFINED))
def test_solve_refined_matches_jax(name):
    """The first cycle (the rank-1 solve and its exact CP residual) to 1e-10.
    The later cycles round a residual whose terms cancel by κ_rep ≈ 3e5-9e5
    (rep_condition) with ALS, which resolves it only to about √eps·κ_rep: the
    two packages take different correction sequences from there (cycles
    [10, 8, 1, 1, 1, 1, 2] against [10, 8, 1, 1, 4] on beats_single_shot), so
    only their outcome is compared: both converge below tol."""
    _, _, got = _refined(name, tkt, device="cpu")
    _, _, ref = _refined(name, tk)
    tol = REFINED[name][3]["tol"]
    assert got.status == ref.status == tkt.Status.CONVERGED
    assert got.inner_iterations[0] == ref.inner_iterations[0]
    np.testing.assert_allclose(got.residual_history[0], ref.residual_history[0], rtol=1e-10)
    np.testing.assert_allclose(got.rep_condition[0], ref.rep_condition[0], rtol=1e-10)
    assert max(got.true_relative_residual, ref.true_relative_residual) < tol


def test_solve_refined_rejects_bad_rhs():
    with pytest.raises(ValueError, match=r"b must be \(d, n\)"):
        tkt.solve_refined(tkt.laplace(2, 8, device="cpu"), torch.ones(3, 8))
