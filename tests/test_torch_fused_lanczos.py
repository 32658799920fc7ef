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
from tensorkrylov_tpu_torch.ops import fused_lanczos
from tensorkrylov_tpu_torch.ops.fused_lanczos import fixed_order_sum, fused_lanczos_core
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


def _kernel_order_sum(x):
    """The sum of 1-D x as the kernels take it, written out step by step:
    each 256-element chunk (zero past the end) is tree-summed, element t plus
    element t + stride for stride 128, 64, ..., 1; lane t of 256 then adds
    the chunk sums t, t + 256, ... in turn from zero; the 256 lane results are
    tree-summed the same way. Every operation is rounded in x's dtype."""
    chunks = -(-len(x) // 256)
    padded = np.zeros(chunks * 256, dtype=x.dtype)
    padded[: len(x)] = x

    def tree(y):
        y = y.copy()
        stride = 128
        while stride >= 1:
            y[:stride] = y[:stride] + y[stride:2 * stride]
            stride //= 2
        return y[0]

    parts = [tree(padded[c * 256:(c + 1) * 256]) for c in range(chunks)]
    lanes = np.zeros(256, dtype=x.dtype)
    for t in range(256):
        acc = x.dtype.type(0)
        for c in range(t, chunks, 256):
            acc = acc + parts[c]
        lanes[t] = acc
    return tree(lanes)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 65536 + 3])
def test_fixed_order_sum_is_the_kernel_order(n, dtype):
    """fixed_order_sum, the plain versions' sum, is the kernels' order bit
    for bit: a change to one without the other fails here."""
    x = np.random.default_rng(n).standard_normal(n).astype(dtype)
    want = _kernel_order_sum(x)
    got = fixed_order_sum(torch.tensor(x)).numpy()
    assert got.dtype == dtype and got.tobytes() == np.asarray(want, dtype=dtype).tobytes()
    # a batch of rows sums each row in the same order
    rows = np.stack([x, x[::-1].copy()])
    assert fixed_order_sum(torch.tensor(rows)).numpy().tobytes() == np.array(
        [want, _kernel_order_sum(rows[1])], dtype=dtype).tobytes()


# The card's answers to the plan's questions, for an H100-like card (132 SMs):
# clusters of G that fit at once, with w in shared memory or not
H100_FIT = {1: 132, 2: 66, 4: 32, 8: 16, 16: 7}


@pytest.mark.parametrize("d,n,dtype,want_G,want_shared", [
    (10, 131072, torch.float64, 8, True),     # 64 chunks of w per block: 128 KB
    (10, 131072, torch.float32, 8, True),
    (2, 1 << 20, torch.float64, 16, False),   # 256 chunks per block: 512 KB, past W_SHARED_BYTES
    (1, 300, torch.float64, 2, True),         # two chunks: no more blocks than chunks
    (200, 4096, torch.float32, 1, True),      # d fills every SM
])
def test_fused_plan(monkeypatch, d, n, dtype, want_G, want_shared):
    """G from the SM count and the cluster occupancy, as the resident
    kernel's plan picks it; w stays in shared memory where a block's part
    fits in W_SHARED_BYTES."""
    asked = []

    def fit(G, device, smem, elt):
        asked.append((G, smem, elt))
        return H100_FIT[G]

    monkeypatch.setattr(fused_lanczos, "_sm_count", lambda device: 132)
    monkeypatch.setattr(fused_lanczos, "_max_active_clusters", fit)
    fused_lanczos._plan.cache_clear()
    G = fused_lanczos.fused_lanczos_plan(d, n, dtype, "cuda:0")
    fused_lanczos._plan.cache_clear()
    assert G == want_G
    assert (fused_lanczos._w_bytes(n, G, dtype.itemsize) > 0) == want_shared
    assert all(elt == dtype.itemsize and smem == fused_lanczos._w_bytes(n, g, elt) for g, smem, elt in asked)
