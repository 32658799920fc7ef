"""The port's multi-apply SpMV (ops/resident_spmv.py) on the CPU against the
JAX package's ``spmv_multi_apply_xla`` and its Pallas kernel ``_multi_apply``
in interpret mode, on the same numpy-seeded inputs."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tensorkrylov_tpu as tk
import tensorkrylov_tpu.ops.pallas.resident_spmv as rs
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.interop import operator_from_numpy
from tensorkrylov_tpu_torch.ops import _build
from tensorkrylov_tpu_torch.ops.banded import spmv_reference
from tensorkrylov_tpu_torch.ops.resident_spmv import spmv_multi_apply, spmv_multi_apply_reference


@pytest.fixture()
def interpret_mode(monkeypatch):
    """The Pallas kernel run by the interpreter, as tests/test_resident_spmv.py runs it."""
    monkeypatch.setattr(rs.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(rs, "_multi_apply", rs._multi_apply.__wrapped__)


def _pair(jop, seed, dtype):
    """The JAX operator and v, and the port's operator and v, with the same bits."""
    v = np.random.default_rng(seed).standard_normal((jop.d, jop.n)).astype(dtype)
    return jnp.asarray(v), operator_from_numpy(np.asarray(jop.bands), jop.offsets, jop.symmetric), torch.tensor(v)


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.max(np.abs(a - ref)) / np.max(np.abs(ref)))


CASES = {
    "laplace_m1": (lambda: tk.laplace(2, 512, dtype=jnp.float32), 1, None),
    "laplace_m2": (lambda: tk.laplace(2, 512, dtype=jnp.float32), 2, None),
    "laplace_m5": (lambda: tk.laplace(2, 512, dtype=jnp.float32), 5, None),
    "conv_diff_m3": (lambda: tk.conv_diff(2, 256, dtype=jnp.float32), 3, 1e-6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_apply_matches_jax(interpret_mode, case):
    """f32 at the JAX test's bound, 1e-5 relative to the largest entry, against
    both the XLA scan and the Pallas kernel."""
    make, m, scale = CASES[case]
    jop = make()
    scale = scale or 1.0 / (4.0 * (jop.n + 1) ** 2)
    jv, op, v = _pair(jop, 0 if case.startswith("laplace") else 1, np.float32)
    got = spmv_multi_apply(op, v, m, scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (jop.d, jop.n)
    assert _rel(got.numpy(), rs.spmv_multi_apply_xla(jop, jv, m, scale)) < 1e-5
    assert _rel(got.numpy(), rs._multi_apply(jop.bands, jv, jop.offsets, m, float(scale))) < 1e-5


@pytest.mark.parametrize("m", [1, 4])
def test_multi_apply_f64_matches_jax(m):
    """f64 (the JAX dispatcher's silent fallback to the scan) at rtol 1e-12."""
    jop = tk.laplace(2, 128)
    jv, op, v = _pair(jop, 2, np.float64)
    got = spmv_multi_apply(op, v, m, 0.5 / (4.0 * 129**2))
    ref = np.asarray(rs.spmv_multi_apply(jop, jv, m, 0.5 / (4.0 * 129**2)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_zero_applies_copy_v():
    jop = tk.laplace(2, 64)
    jv, op, v = _pair(jop, 3, np.float64)
    got = spmv_multi_apply(op, v, 0, 0.25)
    assert torch.equal(got, v) and got.data_ptr() != v.data_ptr()
    np.testing.assert_array_equal(got.numpy(), np.asarray(rs.spmv_multi_apply_xla(jop, jv, 0, 0.25)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_version_is_m_plain_spmvs(dtype):
    """Bit for bit: m calls of spmv_reference, each product times the scale
    rounded to v's dtype first (0.1 is not exact in either type)."""
    op = tkt.conv_diff(3, 97, dtype=dtype, device="cpu")
    v = torch.tensor(np.random.default_rng(4).standard_normal((3, 97)), dtype=dtype)
    c = float(torch.tensor(0.1 / 97**2, dtype=dtype))
    x = v
    for _ in range(6):
        x = spmv_reference(op, x) * c
    launches = dict(_build.launches)
    assert torch.equal(spmv_multi_apply(op, v, 6, 0.1 / 97**2), x)
    assert torch.equal(spmv_multi_apply_reference(op, v, 6, 0.1 / 97**2), x)
    assert dict(_build.launches) == launches  # CPU tensors take the plain version


def test_other_devices_raise():
    op = tkt.laplace(2, 16, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        spmv_multi_apply(op, torch.empty((2, 16), dtype=torch.float64, device="meta"), 2)
