"""The port's nonsymmetric path against the JAX package's, in f64 on the same
numpy inputs: Arnoldi (CGS2) steps, the conv_diff and eigval_matrix
galleries, the two nonsymmetric CP solves, the nonsymmetric projected stage,
and solve() with orth='arnoldi'."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
from tensorkrylov_tpu.coeffs import tables as jtables
from tensorkrylov_tpu.ops import expsum as jexpsum, orth as jorth
from tensorkrylov_tpu.solver import projected_step as jax_projected_step
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.interop import config_from_fields, operator_from_numpy
from tensorkrylov_tpu_torch.ops import expsum
from tensorkrylov_tpu_torch.ops.orth import arnoldi_algorithm, arnoldi_step, init_state
from tensorkrylov_tpu_torch.solver import projected_step

torch.set_num_threads(1)

T = torch.tensor
F64 = torch.float64


def _port(jop, jb):
    return operator_from_numpy(np.asarray(jop.bands), jop.offsets, jop.symmetric), T(np.asarray(jb))


def _assert_state_close(st, jst, atol):
    for name in ("V", "H", "btil", "beta"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(jst, name)), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["conv_diff", "laplace"])
def test_arnoldi_steps_match_jax(kind):
    """CGS2 in f64 on a nonsymmetric and an SPD operator; H is scaled to 1
    (conv_diff's entries are O(n²)), V and b̃ are O(1): all to 1e-12."""
    kmax = 12
    jop = tk.conv_diff(3, 30, c=4.0) if kind == "conv_diff" else tk.laplace(2, 25)
    jop = dataclasses.replace(jop, bands=jop.bands / (jop.n + 1) ** 2)
    jb = tk.random_rhs(jop.d, jop.n, seed=2, identical=False)
    op, b = _port(jop, jb)
    jst, _ = jorth.init_state(jop, jb, kmax, jnp.float64)
    st, _ = init_state(op, b, kmax, F64)
    jstep = jax.jit(functools.partial(jorth.arnoldi_step, proj_dtype=jnp.float64))
    for k in range(1, kmax + 1):
        jst, jloss = jstep(jop, jst, jb, k)
        st, loss = arnoldi_step(op, st, b, k, proj_dtype=F64)
        assert abs(float(loss) - float(jloss)) <= 1e-12
    _assert_state_close(st, jst, 1e-12)


def test_arnoldi_lucky_restart_matches_jax():
    """Diagonal factors with three distinct eigenvalues: the Krylov space is
    invariant after three steps and both packages restart with the same
    fixed direction."""
    diag = np.array([1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 3.0, 1.0])
    jop = tk.eigval_matrix(np.stack([diag, diag + 0.5]))
    jb = jnp.ones((2, 8))
    op, b = _port(jop, jb)
    jst = jorth.arnoldi_algorithm(jop, jb, 6)
    st = arnoldi_algorithm(op, b, 6)
    assert float(st.H[0, 3, 2]) == 0.0
    _assert_state_close(st, jst, 1e-12)


@pytest.mark.parametrize("fields", [dict(), dict(c=3.0, shift=17.5)], ids=["default", "c3_shift"])
def test_conv_diff_bands_equal_jax(fields):
    jop = tk.conv_diff(3, 17, **fields)
    op = tkt.conv_diff(3, 17, **fields, device="cpu")
    assert op.offsets == jop.offsets and not op.symmetric and not jop.symmetric
    np.testing.assert_array_equal(op.bands.numpy(), np.asarray(jop.bands))


def test_eigval_matrix_equals_jax():
    ev = np.linspace(0.5, 4.0, 11)
    for args in ((ev, 3), (np.stack([ev, 2 * ev]), None)):
        jop, op = tk.eigval_matrix(*args), tkt.eigval_matrix(*args, device="cpu")
        assert op.offsets == jop.offsets == (0,) and op.symmetric
        np.testing.assert_array_equal(op.bands.numpy(), np.asarray(jop.bands))
    with pytest.raises(ValueError, match="pass d"):
        tkt.eigval_matrix(ev, device="cpu")


@functools.lru_cache(maxsize=1)
def _hessenberg(k=10, kmax=14):
    """H, b̃ after k Arnoldi steps (JAX) on conv_diff(2, 20), padded to kmax+1."""
    jop = tk.conv_diff(2, 20)
    jst = jorth.arnoldi_algorithm(jop, tk.random_rhs(2, 20, seed=3, identical=False), kmax)
    H = np.asarray(jst.H).copy()
    H[:, k + 1:, :] = 0.0
    H[:, :, k:] = 0.0
    bt = np.asarray(jst.btil).copy()
    bt[:, k + 1:] = 0.0
    return H, bt


def _coeffs(lmin, H):
    st = jtables.select_stenger(1e-9 * lmin / float(np.abs(H).max() * 2), 101)
    return [np.asarray(a) for a in (st.omega, st.alpha, st.t_mask)], jnp.asarray(lmin)


@pytest.mark.parametrize("R", [1, 3])
def test_cp_solve_nonsym_eig_matches_jax(R):
    H, bt = _hessenberg()
    k = 10
    if R > 1:
        bt = np.stack([bt * (r + 1.0) + 0.1 * r for r in range(R)], axis=2)
    (om, al, tm), lmin = _coeffs(300.0, H)
    jw, jY = jexpsum.cp_solve_nonsym_eig(jnp.asarray(H), jnp.asarray(bt), k, om, al, tm, lmin)
    w, Y = expsum.cp_solve_nonsym_eig(T(H), T(bt), k, T(om), T(al), T(tm), T(300.0, dtype=F64))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-14)
    # LAPACK's geev on both sides, eigenvectors scaled and ordered alike or
    # not: S exp(−γΛ) S⁻¹ b̃ is invariant, to the eigenbasis' conditioning
    np.testing.assert_allclose(Y.numpy(), np.asarray(jY), rtol=0, atol=1e-11 * np.abs(np.asarray(jY)).max())


def test_cp_solve_nonsym_expm_matches_jax_and_eig():
    """torch.linalg.matrix_exp (native f64) against the JAX package's LU-free
    Taylor scaling-and-squaring, and against the port's eig solve: both to
    1e-11 relative to the largest factor entry (two f64 expm algorithms, each
    accurate to ~1e-14 on these norms, after ~8 squarings)."""
    H, bt = _hessenberg()
    k = 10
    (om, al, tm), lmin = _coeffs(300.0, H)
    jw, jY = jexpsum.cp_solve_nonsym(jnp.asarray(H), jnp.asarray(bt), k, *map(jnp.asarray, (om, al, tm)), lmin)
    args = (T(H), T(bt), k, T(om), T(al), T(tm), T(300.0, dtype=F64))
    w, Y = expsum.cp_solve_nonsym(*args)
    scale = np.abs(np.asarray(jY)).max()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-14)
    np.testing.assert_allclose(Y.numpy(), np.asarray(jY), rtol=0, atol=1e-11 * scale)
    _, Ye = expsum.cp_solve_nonsym_eig(*args)
    np.testing.assert_allclose(Y.numpy(), Ye.numpy(), rtol=0, atol=1e-11 * scale)


@pytest.mark.parametrize("fields,lmin_override", [
    (dict(), None),
    (dict(), 2.0e3),
    (dict(nonsym_solve_impl="expm"), None),
    (dict(coeff_tol_scale="reference"), None),
], ids=["eig", "lmin_override", "expm", "reference_tol"])
def test_nonsym_projected_step_matches_jax(fields, lmin_override):
    H, bt = _hessenberg()
    k, K = 10, H.shape[1]
    jcfg = tk.SolverConfig(kmax=K - 1, tol=1e-9, orth="arnoldi", tmax=101, **fields)
    jcfg = dataclasses.replace(jcfg, nonsym_solve_impl=fields.get("nonsym_solve_impl", "eig"))
    cfg = config_from_fields({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    ref = jax_projected_step(jnp.asarray(H), jnp.asarray(bt), jnp.asarray(H[:, k, k - 1]), k, jnp.asarray(1.0),
                             jcfg, None, False, 20, None, lmin_override)
    got = projected_step(T(H), T(bt), T(H[:, k, k - 1]), k, T(1.0, dtype=F64), cfg, None, False, 20, None,
                         lmin_override)
    assert int(got.rank) == int(ref.rank) and bool(got.breakdown) == bool(ref.breakdown)
    for name in ("weights", "lmin", "lmax", "rel"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-9, err_msg=name)
    np.testing.assert_allclose(got.Y.numpy(), np.asarray(ref.Y), rtol=0, atol=1e-11 * np.abs(np.asarray(ref.Y)).max())


def test_solve_arnoldi_conv_diff_matches_jax():
    """The verify recipe: conv_diff(3, 30), Arnoldi, the rank-601 sinc rule.
    Same status and steps as the JAX package's solve, estimates to 1e-6
    relative (LAPACK eig and CGS2 sums round their own way in each package),
    and the dense-oracle residual ≤ 1e-8."""
    jop, jb = tk.conv_diff(3, 30), tk.random_rhs(3, 30, seed=7)
    jcfg = tk.SolverConfig(kmax=30, tol=1e-8, orth="arnoldi", tmax=601, check_every=3)
    ref = tk.solve(jop, jb, jcfg)
    op, b = _port(jop, jb)
    res = tkt.solve(op, b, config_from_fields({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}))
    assert res.config.orth == "arnoldi" and res.config.nonsym_solve_impl == "eig"
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations))
    assert res.status == tkt.Status.CONVERGED
    rr, jrr = res.relative_residual.numpy(), np.asarray(ref.relative_residual)
    idx = np.flatnonzero(np.isfinite(jrr))
    np.testing.assert_allclose(rr[idx], jrr[idx], rtol=1e-6)
    np.testing.assert_array_equal(res.expsum_rank.numpy(), np.asarray(ref.expsum_rank))
    assert tkt.kron_residual_dense(op, res.x, b) <= 1e-8
