"""The port's banded SpMV (its plain version, which CPU tensors take) against
the JAX package's ops/banded.spmv and its Pallas kernel in interpreter mode."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tensorkrylov_tpu as tk
import tensorkrylov_tpu.ops.pallas.banded_spmv as ps
from tensorkrylov_tpu.ops.banded import spmv as jax_spmv
from tensorkrylov_tpu_torch.interop import operator_from_numpy
from tensorkrylov_tpu_torch.models.gallery import bands_to_dense
from tensorkrylov_tpu_torch.ops import _build
from tensorkrylov_tpu_torch.ops.banded import spmv, spmv_dense_oracle

OFFSETS = {"tri": (-1, 0, 1), "penta": (-2, -1, 0, 1, 2)}
# relative to max|u|: both sides add the same rounded products in band order,
# so the bounds are a few units of the last place
RTOL = {np.float32: 1e-6, np.float64: 1e-14}


def _bands(offsets, d, n, seed, dtype):
    """Random bands with the operator's convention: out-of-range entries are zero."""
    bands = np.random.default_rng(seed).standard_normal((d, len(offsets), n))
    for b, off in enumerate(offsets):
        if off > 0:
            bands[:, b, n - off:] = 0.0
        elif off < 0:
            bands[:, b, :-off] = 0.0
    return bands.astype(dtype)


def _err(a, ref):
    return float(np.max(np.abs(np.asarray(a) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("band", sorted(OFFSETS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmv_matches_jax(dtype, band, ndim):
    d, n = 3, 97
    offsets = OFFSETS[band]
    bands = _bands(offsets, d, n, 0, dtype)
    shape = (d, n) if ndim == 2 else (d, 4, n)
    v = np.random.default_rng(1).standard_normal(shape).astype(dtype)
    jop = tk.KroneckerSumOperator(jnp.asarray(bands), offsets, True)
    ref = np.asarray(jax_spmv(jop, jnp.asarray(v)))
    before = dict(_build.launches)
    got = spmv(operator_from_numpy(bands, offsets), torch.tensor(v))
    assert got.dtype == torch.from_numpy(v).dtype and tuple(got.shape) == shape
    assert _err(got.numpy(), ref) <= RTOL[dtype]
    assert dict(_build.launches) == before  # a CPU tensor never reaches the kernel


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ps.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    # bypass the jit cache (it would hold the compiled non-interpret version)
    monkeypatch.setattr(ps, "_spmv_pallas", ps._spmv_pallas.__wrapped__)


@pytest.mark.parametrize("band", sorted(OFFSETS))
def test_spmv_matches_pallas_kernel(interpret_mode, band):
    d, n = 2, 512
    offsets = OFFSETS[band]
    bands = _bands(offsets, d, n, 2, np.float32)
    v = np.random.default_rng(3).standard_normal((d, n)).astype(np.float32)
    ref = np.asarray(ps._spmv_pallas(jnp.asarray(bands), jnp.asarray(v), offsets, 256))
    got = spmv(operator_from_numpy(bands, offsets), torch.tensor(v)).numpy()
    assert _err(got, ref) <= 1e-6  # f32: the Pallas kernel sums the same terms in the same order


def test_spmv_matches_dense_oracle():
    op = operator_from_numpy(_bands(OFFSETS["penta"], 3, 20, 4, np.float64), OFFSETS["penta"])
    v = torch.tensor(np.random.default_rng(5).standard_normal((3, 20)))
    ref = spmv_dense_oracle(torch.tensor(bands_to_dense(op)), v)
    torch.testing.assert_close(spmv(op, v), ref, rtol=1e-13, atol=1e-13)


def test_spmv_rejects_other_devices():
    op = operator_from_numpy(_bands(OFFSETS["tri"], 2, 8, 6, np.float64), OFFSETS["tri"])
    with pytest.raises(ValueError, match="cuda or cpu"):
        spmv(op, torch.empty((2, 8), dtype=torch.float64, device="meta"))
