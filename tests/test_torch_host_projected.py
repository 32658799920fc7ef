"""The port's solve_host_projected against the JAX package's, on the CPU: the
resident route (the JAX kernel in interpret mode, the port's plain version),
the unfused route in f64, the nonsymmetric Arnoldi path, a segment update
driven from one JAX mid-solve state, and the recorded fallbacks."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tensorkrylov_tpu as tk
import tensorkrylov_tpu.ops.pallas.resident_lanczos as rl
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu.ops import orth as jorth
from tensorkrylov_tpu.solver import _resident_segment_update as jax_segment_update
from tensorkrylov_tpu_torch.interop import (
    config_from_fields,
    krylov_state_from_numpy,
    krylov_state_to_numpy,
    operator_from_numpy,
    result_to_numpy,
)
from tensorkrylov_tpu_torch.solver import _resident_segment_update

torch.set_num_threads(1)


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(rl.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(rl, "_resident_steps_chunk", rl._resident_steps_chunk.__wrapped__)


def _port_config(jcfg):
    return config_from_fields({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _both(jop, jb, jcfg, symmetric=True):
    """The JAX package's and the port's solve_host_projected on the same inputs."""
    ref = tk.solve_host_projected(jop, jb, jcfg)
    op = operator_from_numpy(np.asarray(jop.bands), jop.offsets, symmetric)
    res = tkt.solve_host_projected(op, torch.tensor(np.asarray(jb)), _port_config(jcfg))
    return ref, res, op


def _checked(ref):
    """Indices of the checks that both packages record (finite, nonzero)."""
    r = np.asarray(ref.relative_residual)
    return np.flatnonzero(np.isfinite(r) & (r > 0))


def test_resident_route_matches_jax(interpret_mode):
    """The config of tests/test_resident_lanczos.py:81-98: both packages run
    the plain f32 recurrence, summed in other orders; their estimates agree
    to that test's bounds (below ~1e-5 they sit at the f32 noise floor)."""
    d, n = 2, 128
    jop = tk.laplace(d, n, shift=5e4, dtype=jnp.float32)
    jb = tk.random_rhs(d, n, seed=3).astype(jnp.float32)
    jb = jb / jnp.linalg.norm(jb, axis=1, keepdims=True)
    jcfg = tk.SolverConfig(kmax=8, tol=1e-30, check_every=4, orth="lanczos", basis_dtype=jnp.float32,
                           step_impl="resident", spectral_source="H")
    ref, res, _ = _both(jop, jb, jcfg)
    assert ref.config.step_impl == res.config.step_impl == "resident"
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations))
    idx = _checked(ref)
    np.testing.assert_allclose(res.relative_residual.numpy()[idx], np.asarray(ref.relative_residual)[idx],
                               rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(res.lambda_min.numpy()[idx], np.asarray(ref.lambda_min)[idx], rtol=1e-5)
    np.testing.assert_allclose(res.lambda_max.numpy()[idx], np.asarray(ref.lambda_max)[idx], rtol=1e-5)


def test_xla_route_matches_jax_f64():
    """Reorthogonalized Lanczos in f64 on the unfused route: the same
    recurrence up to f64 rounding, and the same projected stage on the host."""
    jop = tk.laplace(3, 30)
    jb = tk.random_rhs(3, 30, seed=7)
    jb = jb / jnp.linalg.norm(jb, axis=1, keepdims=True)
    jcfg = tk.SolverConfig(kmax=30, tol=1e-8, orth="lanczos_reorth", check_every=4)
    ref, res, op = _both(jop, jb, jcfg)
    assert res.config.step_impl == "xla"
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations))
    assert res.status == tkt.Status.CONVERGED
    idx = _checked(ref)
    got = result_to_numpy(res)
    for f in ("relative_residual", "lambda_min", "lambda_max"):
        np.testing.assert_allclose(got[f][idx], np.asarray(getattr(ref, f))[idx], rtol=1e-10)
    np.testing.assert_array_equal(got["expsum_rank"], np.asarray(ref.expsum_rank))
    np.testing.assert_allclose(got["orthogonality"], np.asarray(ref.orthogonality), rtol=0, atol=1e-12)
    assert tkt.kron_residual_dense(op, res.x, torch.tensor(np.asarray(jb))) <= 1e-8


def test_conv_diff_arnoldi_matches_jax():
    """The nonsymmetric path: Arnoldi (CGS2), the host's exact λ_min, the sinc
    rule and the eig solve. Each package's LAPACK eig and CGS2 sums round
    their own way; the estimates agree to 1e-6 relative, the λ traces to
    1e-9, and the dense-oracle residual is ≤ 1e-8."""
    jop, jb = tk.conv_diff(3, 30), tk.random_rhs(3, 30, seed=7)
    jcfg = tk.SolverConfig(kmax=30, tol=1e-8, orth="arnoldi", tmax=601, check_every=5)
    ref, res, op = _both(jop, jb, jcfg, symmetric=False)
    assert res.config.nonsym_solve_impl == "eig" and res.config.step_impl == "xla"
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations))
    assert res.status == tkt.Status.CONVERGED
    idx = _checked(ref)
    np.testing.assert_allclose(res.relative_residual.numpy()[idx], np.asarray(ref.relative_residual)[idx], rtol=1e-6)
    for f in ("lambda_min", "lambda_max"):
        np.testing.assert_allclose(getattr(res, f).numpy()[idx], np.asarray(getattr(ref, f))[idx], rtol=1e-9)
    np.testing.assert_array_equal(res.expsum_rank.numpy(), np.asarray(ref.expsum_rank))
    assert tkt.kron_residual_dense(op, res.x, torch.tensor(np.asarray(jb))) <= 1e-8


def test_segment_update_from_jax_state(interpret_mode):
    """One mid-solve state of the JAX package (init_state and three plain f32
    steps) drives both packages' resident segment update over steps 4..8."""
    d, n, kmax = 2, 256, 10
    jop = tk.laplace(d, n, shift=40.0, dtype=jnp.float32)
    jb = tk.random_rhs(d, n, seed=5, identical=False)
    jst, _ = jorth.init_state(jop, jb, kmax, jnp.float64, jnp.float32)
    step = jax.jit(functools.partial(jorth.lanczos_step, reorth=False, proj_dtype=jnp.float64))
    for k in range(1, 4):
        jst, _ = step(jop, jst, jb, k)
    st = krylov_state_from_numpy(*krylov_state_to_numpy(jst))
    ref = krylov_state_to_numpy(jax_segment_update(jop.bands, jst, jb, jop.offsets, jnp.asarray(4, jnp.int32), S=5))
    op = operator_from_numpy(np.asarray(jop.bands), jop.offsets)
    got = krylov_state_to_numpy(_resident_segment_update(op, st, torch.tensor(np.asarray(jb)), 4, 5))
    # f32 recurrences summed in other orders: the bounds of the kernel test
    np.testing.assert_allclose(got.V, ref.V, rtol=0, atol=5e-4)
    hscale = np.abs(ref.H).max()
    np.testing.assert_allclose(got.H, ref.H, rtol=0, atol=2e-4 * hscale)
    np.testing.assert_allclose(got.btil, ref.btil, rtol=0, atol=5e-4 * np.abs(ref.btil).max())
    np.testing.assert_allclose(got.beta, ref.beta, rtol=2e-4)
    assert got.V.dtype == np.float32 and got.H.dtype == np.float64
    assert np.count_nonzero(got.V[9:]) == 0 and np.count_nonzero(got.H[:, 9:, 9:]) == 0


@pytest.mark.parametrize("fields,n,resolved", [
    (dict(orth="lanczos", basis_dtype=torch.float32), 100, "resident"),
    (dict(orth="lanczos", basis_dtype=torch.float64), 128, "xla"),
    (dict(orth="lanczos_reorth", basis_dtype=torch.float32), 128, "xla"),
], ids=["n100_eligible", "f64_basis", "reorth"])
def test_resident_fallbacks_recorded(fields, n, resolved):
    """Where the JAX package falls back (tests/test_resident_lanczos.py:101-111
    expects 'xla' at n=100, since its TPU kernel needs n % 128 == 0), the port
    runs the kernel: the CUDA kernel masks its loads and takes any n. An f64
    basis or a reorthogonalized recurrence still falls back, recorded."""
    op = tkt.laplace(2, n, shift=100.0, device="cpu")
    b = tkt.random_rhs(2, n, seed=3)
    r = tkt.solve_host_projected(op, b, tkt.SolverConfig(kmax=4, tol=1e-30, check_every=2, step_impl="resident",
                                                         spectral_source="H", **fields))
    assert r.config.step_impl == resolved
    assert r.niterations == 4 and bool(torch.isfinite(r.x.factors).all())
