"""The port's Lanczos steps (ops/orth.py) against the JAX package's, on the
same numpy inputs, in f64 unless stated."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
from tensorkrylov_tpu.ops import orth as jorth
from tensorkrylov_tpu_torch.interop import operator_from_numpy
from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_algorithm, lanczos_step, orthogonality_loss

F64 = torch.float64


def _ops(kind):
    if kind == "laplace":
        jop, jb = tk.laplace(3, 40), tk.random_rhs(3, 40, seed=1, identical=False)
    else:  # distinct dense SPD factors Q diag(1..3) Qᵀ: 23 bands, κ = 3
        rng = np.random.default_rng(2)
        mats = []
        for _ in range(2):
            q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
            mats.append(q @ np.diag(np.linspace(1.0, 3.0, 12)) @ q.T)
        jop = tk.operator_from_dense_factors(np.stack(mats), symmetric=True)
        jb = tk.random_rhs(2, 12, seed=3, identical=False)
    op = operator_from_numpy(np.asarray(jop.bands), jop.offsets)
    return jop, jb, op, torch.tensor(np.asarray(jb))


def _jstep(reorth):
    return jax.jit(functools.partial(jorth.lanczos_step, reorth=reorth, proj_dtype=jnp.float64))


def _assert_state_close(st, jst, scale_atol):
    scale = float(np.max(np.abs(np.asarray(jst.H))))
    np.testing.assert_allclose(st.H.numpy(), np.asarray(jst.H), rtol=0, atol=scale_atol * scale)
    np.testing.assert_allclose(st.V.numpy(), np.asarray(jst.V), rtol=0, atol=1e3 * scale_atol)
    bscale = float(np.max(np.abs(np.asarray(jst.btil))))
    np.testing.assert_allclose(st.btil.numpy(), np.asarray(jst.btil), rtol=0, atol=scale_atol * bscale)
    np.testing.assert_allclose(st.beta.numpy(), np.asarray(jst.beta), rtol=0, atol=scale_atol * scale)


def test_init_state_matches_jax():
    jop, jb, op, b = _ops("laplace")
    jst, jn = jorth.init_state(jop, jb, 5, jnp.float64)
    st, bn = init_state(op, b, 5, F64)
    np.testing.assert_allclose(bn.numpy(), np.asarray(jn), rtol=1e-15)
    _assert_state_close(st, jst, 1e-15)


# f64, 10 steps: sums are taken in other orders, so agreement is to a few
# hundred units of f64 rounding relative to ‖H‖
@pytest.mark.parametrize("kind", ["laplace", "dense_distinct"])
@pytest.mark.parametrize("reorth", [False, True, "auto"], ids=["plain", "always", "auto"])
def test_lanczos_steps_match_jax(kind, reorth):
    kmax = 10
    jop, jb, op, b = _ops(kind)
    jst, _ = jorth.init_state(jop, jb, kmax, jnp.float64)
    st, _ = init_state(op, b, kmax, F64)
    jstep = _jstep(reorth)
    for k in range(1, kmax + 1):
        jst, jloss = jstep(jop, jst, jb, k)
        st, loss = lanczos_step(op, st, b, k, reorth=reorth, proj_dtype=F64)
        # the loss estimate measures accumulated rounding, which each package
        # rounds its own way: it must agree in order of magnitude
        lo, hi = sorted((float(loss), float(jloss)))
        assert hi <= 1e-12 or hi <= 4.0 * lo
    _assert_state_close(st, jst, 1e-13)


def test_f32_basis_matches_jax():
    """f32 basis, f64 projected algebra: the step computes in f32."""
    jop, jb, op, b = _ops("laplace")
    kmax = 8
    jst, _ = jorth.init_state(jop.astype(jnp.float32), jb, kmax, jnp.float64, jnp.float32)
    op32 = op.astype(torch.float32)
    st, _ = init_state(op32, b, kmax, F64, torch.float32)
    jstep = _jstep(False)
    for k in range(1, kmax + 1):
        jst, _ = jstep(jop.astype(jnp.float32), jst, jb, k)
        st, _ = lanczos_step(op32, st, b, k, reorth=False, proj_dtype=F64)
    assert st.V.dtype == torch.float32
    scale = float(np.max(np.abs(np.asarray(jst.H))))
    np.testing.assert_allclose(st.H.numpy(), np.asarray(jst.H), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(st.V.numpy(), np.asarray(jst.V), rtol=0, atol=1e-4)


def test_lucky_restart_matches_jax():
    """Diagonal factors with 3 distinct eigenvalues: the Krylov space is
    invariant after 3 steps, and both packages restart with the same fixed
    direction."""
    n = 8
    diag = np.array([1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 3.0, 1.0])
    jop = tk.operator_from_dense_factors(np.stack([np.diag(diag), np.diag(diag + 0.5)]), symmetric=True)
    jb = jnp.ones((2, n))
    op = operator_from_numpy(np.asarray(jop.bands), jop.offsets)
    b = torch.ones((2, n), dtype=F64)
    kmax = 6
    jst, _ = jorth.init_state(jop, jb, kmax, jnp.float64)
    st, _ = init_state(op, b, kmax, F64)
    jstep = _jstep(True)
    for k in range(1, kmax + 1):
        jst, _ = jstep(jop, jst, jb, k)
        st, _ = lanczos_step(op, st, b, k, reorth=True, proj_dtype=F64)
    assert float(st.H[0, 3, 2]) == 0.0  # β stays 0 at the breakdown
    _assert_state_close(st, jst, 1e-12)


def test_lanczos_algorithm_and_orthogonality_loss_match_jax():
    jop, jb, op, b = _ops("laplace")
    jst = jorth.lanczos_algorithm(jop, jb, 12, reorth=True)
    st = lanczos_algorithm(op, b, 12, reorth=True)
    _assert_state_close(st, jst, 1e-13)
    loss = float(orthogonality_loss(st.V, 13))
    assert loss == pytest.approx(float(jorth.orthogonality_loss(jst.V, 13)), rel=1e-3, abs=1e-14)
    assert loss < 1e-13
