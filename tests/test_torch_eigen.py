"""The port's Sturm bisection and Bendixson bound (ops/eigen.py) against the
JAX package's on the same numpy-seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorkrylov_tpu.ops.eigen import bendixson_lambda_min as jax_bendixson
from tensorkrylov_tpu.ops.eigen import tridiag_eigvalsh_sturm as jax_sturm
from tensorkrylov_tpu_torch.ops.eigen import bendixson_lambda_min, tridiag_eigvalsh_sturm


def _tridiag_inputs():
    """tests/test_ops.py::test_sturm_bisection's inputs."""
    rng = np.random.default_rng(6)
    d, K, k = 2, 16, 11
    return rng.standard_normal((d, K)), rng.standard_normal((d, K)), k


@pytest.mark.parametrize("k", [11, None])
def test_sturm_matches_jax(k):
    """Same Gershgorin start, masked slots and n_iter: every slot to 1e-12,
    the inactive ones included; the active ones equal numpy's eigvalsh."""
    diag, off, k_test = _tridiag_inputs()
    k = k_test if k is not None else None
    got = tridiag_eigvalsh_sturm(torch.tensor(diag), torch.tensor(off), k).numpy()
    ref = np.asarray(jax_sturm(jnp.asarray(diag), jnp.asarray(off), k))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    kk = k or diag.shape[1]
    for s in range(diag.shape[0]):
        T = np.diag(diag[s, :kk]) + np.diag(off[s, 1:kk], 1) + np.diag(off[s, 1:kk], -1)
        np.testing.assert_allclose(np.sort(got[s])[:kk], np.linalg.eigvalsh(T), atol=1e-9)


def test_sturm_few_iterations_match_jax():
    """After 5 halvings the brackets are still wide: the same bisection path."""
    diag, off, k = _tridiag_inputs()
    got = tridiag_eigvalsh_sturm(torch.tensor(diag), torch.tensor(off), k, n_iter=5).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_sturm(jnp.asarray(diag), jnp.asarray(off), k, n_iter=5)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k", [7, 12])
def test_bendixson_matches_jax(k):
    """Σ_s λ_min of the symmetric parts' active minors, to 1e-12, and a lower
    bound on the real parts of the minors' Kronecker-sum spectrum."""
    rng = np.random.default_rng(6)
    W = rng.standard_normal((2, 12, 12)) + 6.0 * np.eye(12)
    got = float(bendixson_lambda_min(torch.tensor(W), k))
    ref = float(jax_bendixson(jnp.asarray(W), k))
    assert got == pytest.approx(ref, rel=1e-12, abs=1e-12)
    true_min = sum(np.linalg.eigvals(W[s, :k, :k]).real.min() for s in range(2))
    assert got <= true_min + 1e-12
