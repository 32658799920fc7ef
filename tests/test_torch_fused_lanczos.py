"""The port's fused Lanczos core (its plain version, which CPU tensors take)
against the JAX package's Pallas kernel in interpreter mode (f32) and its
unfused formula (f64)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tensorkrylov_tpu as tk
import tensorkrylov_tpu.ops.pallas.fused_lanczos as fl
from tensorkrylov_tpu.ops.banded import spmv as jax_spmv
from tensorkrylov_tpu.ops.orth import init_state as jax_init_state, lanczos_step as jax_lanczos_step
from tensorkrylov_tpu_torch.interop import operator_from_numpy
from tensorkrylov_tpu_torch.ops.fused_lanczos import fused_lanczos_core
from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_step

OFFSETS = {"tri": (-1, 0, 1), "penta": (-2, -1, 0, 1, 2)}


def _inputs(offsets, d, n, seed, dtype):
    rng = np.random.default_rng(seed)
    bands = rng.uniform(-1.0, 1.0, (d, len(offsets), n))
    for b, off in enumerate(offsets):
        if off > 0:
            bands[:, b, n - off:] = 0.0
        elif off < 0:
            bands[:, b, :-off] = 0.0
    vecs = [rng.standard_normal((d, n)) for _ in range(3)]
    beta = rng.standard_normal(d)
    return [x.astype(dtype) for x in (bands, *vecs, beta)]


def _port(offsets, bands, v_prev, v_pprev, b, beta):
    op = operator_from_numpy(bands, offsets)
    out = fused_lanczos_core(op, *(torch.tensor(x) for x in (v_prev, v_pprev, beta, b)))
    return [t.numpy() for t in out]


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(fl.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    # bypass the jit cache (it would hold the compiled non-interpret version)
    monkeypatch.setattr(fl, "_fused_core", fl._fused_core.__wrapped__)


@pytest.mark.parametrize("band", sorted(OFFSETS))
def test_fused_core_matches_pallas_kernel_f32(interpret_mode, band):
    offsets = OFFSETS[band]
    bands, v_prev, v_pprev, b, beta = _inputs(offsets, 3, 512, 0, np.float32)
    jop = tk.KroneckerSumOperator(jnp.asarray(bands), offsets, True)
    ref = fl.fused_lanczos_core(jop, *map(jnp.asarray, (v_prev, v_pprev, beta, b)), 256)
    got = _port(offsets, bands, v_prev, v_pprev, b, beta)
    # f32 sums in another order (the kernel keeps 128-lane partials): the
    # bounds of tests/test_fused_step.py
    u, alpha, beta_sq, ub = (np.asarray(r) for r in ref)
    np.testing.assert_allclose(got[1], alpha, rtol=2e-5)
    np.testing.assert_allclose(got[0], u, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got[2], beta_sq, rtol=2e-4)
    np.testing.assert_allclose(got[3], ub, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("band", sorted(OFFSETS))
def test_fused_core_matches_jax_formula_f64(band):
    offsets = OFFSETS[band]
    bands, v_prev, v_pprev, b, beta = _inputs(offsets, 3, 301, 1, np.float64)
    jop = tk.KroneckerSumOperator(jnp.asarray(bands), offsets, True)
    w = jax_spmv(jop, jnp.asarray(v_prev)) - jnp.asarray(beta)[:, None] * v_pprev
    alpha = jnp.einsum("dn,dn->d", w, v_prev)
    u = w - alpha[:, None] * v_prev
    ref = [u, alpha, jnp.einsum("dn,dn->d", u, u), jnp.einsum("dn,dn->d", u, b)]
    got = _port(offsets, bands, v_prev, v_pprev, b, beta)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.max(np.abs(g - r)) <= 1e-13 * np.max(np.abs(r))  # f64, sums reordered


@pytest.mark.parametrize("reorth", [False, "auto"])
def test_fused_steps_match_jax_steps_f64(reorth):
    """lanczos_step(fused=True) in f64 against the JAX package's unfused step
    (the JAX fused kernel is f32-only)."""
    d, n, kmax = 2, 64, 8
    jop = tk.laplace(d, n)
    jb = tk.random_rhs(d, n, seed=3, identical=False)
    op = operator_from_numpy(np.asarray(jop.bands), jop.offsets)
    b = torch.tensor(np.asarray(jb))
    jst, _ = jax_init_state(jop, jb, kmax, jnp.float64)
    st, _ = init_state(op, b, kmax, torch.float64)
    jstep = jax.jit(functools.partial(jax_lanczos_step, reorth=reorth, proj_dtype=jnp.float64))
    for k in range(1, kmax + 1):
        jst, _ = jstep(jop, jst, jb, k)
        st, _ = lanczos_step(op, st, b, k, reorth=reorth, proj_dtype=torch.float64, fused=True)
    scale = float(np.max(np.abs(np.asarray(jst.H))))
    np.testing.assert_allclose(st.H.numpy(), np.asarray(jst.H), rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(st.V.numpy(), np.asarray(jst.V), rtol=0, atol=1e-10)
    np.testing.assert_allclose(st.btil.numpy(), np.asarray(jst.btil), rtol=0, atol=1e-12)


def test_fused_core_rejects_other_devices():
    offsets = OFFSETS["tri"]
    op = operator_from_numpy(_inputs(offsets, 2, 8, 2, np.float64)[0], offsets)
    meta = torch.empty((2, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_lanczos_core(op, meta, meta, torch.empty(2, device="meta"), meta)
