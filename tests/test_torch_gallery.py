"""The port's problem gallery, right-hand sides and CP oracles against the
JAX package's: the same numpy construction must give the same numbers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu.models import gallery as jgallery
from tensorkrylov_tpu.utils import cp as jcp


@pytest.mark.parametrize("name,args", [
    ("laplace", (3, 17)),
    ("reaction_diffusion", (2, 11, 37.5)),
    ("rand_spd", (2, 6)),
])
def test_gallery_matches_jax(name, args):
    jop = getattr(tk, name)(*args)
    op = getattr(tkt, name)(*args, device="cpu")
    assert op.offsets == jop.offsets and op.symmetric == jop.symmetric
    assert op.bands.dtype == torch.float64
    np.testing.assert_array_equal(op.bands.numpy(), np.asarray(jop.bands))


def test_dense_bands_round_trip_matches_jax():
    mats = np.random.default_rng(0).standard_normal((2, 7, 7)) * (np.abs(np.subtract.outer(range(7), range(7))) <= 2)
    bands, offsets = tkt.dense_to_bands(mats)
    jbands, joffsets = jgallery.dense_to_bands(mats)
    assert offsets == joffsets
    np.testing.assert_array_equal(bands, jbands)
    op = tkt.operator_from_dense_factors(mats, symmetric=False, device="cpu")
    np.testing.assert_array_equal(tkt.bands_to_dense(op), mats)
    with pytest.raises(ValueError, match="different sizes"):
        tkt.operator_from_dense_factors([np.eye(3), np.eye(4)], symmetric=True, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    """The constructors make their operator on the CUDA device unless asked
    for the CPU; without a card the default raises and names device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: tkt.laplace(3, 8, **kw), lambda **kw: tkt.conv_diff(2, 8, **kw),
                 lambda **kw: tkt.eigval_matrix(np.arange(1.0, 9.0), d=2, **kw)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
        assert make(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("identical", [True, False])
def test_random_rhs_matches_jax(identical):
    b = tkt.random_rhs(3, 20, seed=5, identical=identical)
    np.testing.assert_array_equal(b.numpy(), np.asarray(tk.random_rhs(3, 20, seed=5, identical=identical)))


def test_cp_oracles_match_jax():
    rng = np.random.default_rng(1)
    w, f = rng.standard_normal(4), rng.standard_normal((3, 5, 4))
    w2, f2 = rng.standard_normal(2), rng.standard_normal((3, 5, 2))
    x, y = tkt.CPTensor(torch.tensor(w), torch.tensor(f)), tkt.CPTensor(torch.tensor(w2), torch.tensor(f2))
    jx, jy = tk.CPTensor(jnp.asarray(w), jnp.asarray(f)), tk.CPTensor(jnp.asarray(w2), jnp.asarray(f2))
    np.testing.assert_allclose(float(tkt.cp_dot(x, y)), float(jcp.cp_dot(jx, jy)), rtol=1e-13)
    np.testing.assert_allclose(float(tkt.cp_norm(x)), float(jcp.cp_norm(jx)), rtol=1e-13)
    np.testing.assert_allclose(tkt.cp_full(x), jcp.cp_full(jx), rtol=1e-13)
    op, jop = tkt.laplace(3, 5, device="cpu"), tk.laplace(3, 5)
    v = rng.standard_normal(125)
    np.testing.assert_allclose(tkt.kron_matvec_dense(op, v), jcp.kron_matvec_dense(jop, v), rtol=1e-13)
    b = rng.random((3, 5))
    assert tkt.kron_residual_dense(op, x, torch.tensor(b)) == pytest.approx(
        jcp.kron_residual_dense(jop, jx, b), rel=1e-12)
