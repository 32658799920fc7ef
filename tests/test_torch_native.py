"""The port's host C++ runtime (native.py): dense_to_bands and parse_bh_file
against their JAX twins, on the C++ route and on the fallback route."""
import shutil

import numpy as np
import pytest

from tensorkrylov_tpu import native as jnative
from tensorkrylov_tpu.coeffs.preprocess import parse_coefficient_file as jparse
from tensorkrylov_tpu.models.gallery import dense_to_bands as jdense_to_bands
from tensorkrylov_tpu_torch import native

ROUTES = ["native", "fallback"]


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """The C++ library (which must build here) or, with it withheld, the fallbacks."""
    if request.param == "native":
        if not (shutil.which("g++") or shutil.which("c++")):
            pytest.skip("no C++ compiler")
        assert native.runtime() == "native", native.build_info
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
        assert native.runtime() == "numpy"
    return request.param


def test_every_name_of_the_jax_module():
    assert set(jnative.__all__) <= set(native.__all__)
    for name in native.__all__:
        assert hasattr(native, name), name


def _banded(rng, d, n, offsets):
    mats = np.zeros((d, n, n))
    for s in range(d):
        for o in offsets:
            mats[s] += np.diag(rng.standard_normal(n - abs(o)), o)
    return mats


@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-3, -1, 0, 2), (0,), (-39, 5, 39)])
def test_dense_to_bands_matches_jax(route, offsets):
    """Random banded (2, 40, 40) factors: the same offsets and the same bands, bit for bit."""
    mats = _banded(np.random.default_rng(len(offsets)), 2, 40, offsets)
    bands, offs = native.dense_to_bands(mats)
    jbands, joffs = jdense_to_bands(mats)
    assert offs == tuple(joffs) == tuple(sorted(offsets))
    assert bands.dtype == np.float64 and bands.shape == (2, len(offsets), 40)
    assert bands.tobytes() == np.asarray(jbands, np.float64).tobytes()


def test_dense_to_bands_of_zeros_is_the_main_diagonal(route):
    bands, offs = native.dense_to_bands(np.zeros((2, 5, 5)))
    jbands, joffs = jdense_to_bands(np.zeros((2, 5, 5)))
    assert offs == tuple(joffs) == (0,) and not bands.any() and bands.shape == jbands.shape == (2, 1, 5)


@pytest.mark.parametrize("shape", [(2, 5, 4), (5, 5)])
def test_dense_to_bands_refuses_other_shapes(route, shape):
    """The C++ loop reads n·n values a factor: anything but (d, n, n) is refused on both routes."""
    with pytest.raises(ValueError, match=r"\(d, n, n\)"):
        native.dense_to_bands(np.ones(shape))


def _coefficient_file(path, t, seed):
    """A Braess–Hackbusch file: t lines of ω, then t of α, 40 digits and a label each."""
    rng = np.random.default_rng(seed)
    digits = lambda: f"{rng.integers(0, 10)}." + "".join(map(str, rng.integers(0, 10, 40)))
    lines = [f"  {digits()}   {{omega[{i + 1}]}}" for i in range(t)]
    lines += [f"  {digits()}   {{alpha[{i + 1}]}}" for i in range(t)]
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("t", [1, 4, 17])
def test_parse_bh_file_matches_jax(route, tmp_path, t):
    """A synthetic file: the same doubles as the JAX package's parser, bit for bit."""
    path = _coefficient_file(tmp_path / f"1_xk{t:02d}.3_1", t, t)
    omega, alpha = native.parse_bh_file(str(path), t)
    jomega, jalpha = jparse(str(path), t)
    assert omega.dtype == alpha.dtype == np.float64 and omega.shape == alpha.shape == (t,)
    assert omega.tobytes() == jomega.tobytes() and alpha.tobytes() == jalpha.tobytes()


def test_parse_bh_file_refuses_a_wrong_count(route, tmp_path):
    path = _coefficient_file(tmp_path / "1_xk03.3_1", 3, 0)
    with pytest.raises(ValueError):
        native.parse_bh_file(str(path), 4)
    with pytest.raises(ValueError):
        native.parse_bh_file(str(path), 2)
