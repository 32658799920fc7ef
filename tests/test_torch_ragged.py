"""Ragged per-mode sizes through the port's pad-to-max constructors, the
scipy constructor, and the analytic Laplacian eigenvectors, on the CPU:
against the JAX package and the dense ragged oracle (tests/test_ragged.py's
cases)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu.models import gallery as jgallery
from tensorkrylov_tpu.ops import eigen as jeigen
from tensorkrylov_tpu_torch.ops import eigen

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)


def _lap(n, shift=0.0):
    h = 1.0 / (n + 1)
    A = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1) + np.diag(np.full(n - 1, -1.0), -1)) / h**2
    return A + shift * np.eye(n)


def _ragged_dense_solve(mats, b_factors):
    """The ragged Kronecker-sum solve by full materialization."""
    sizes = [A.shape[0] for A in mats]
    N = int(np.prod(sizes))
    A_full = np.zeros((N, N))
    for s in range(len(mats)):
        term = np.array([[1.0]])
        for r in range(len(mats)):
            term = np.kron(term, mats[r] if r == s else np.eye(sizes[r]))
        A_full += term
    b_full = np.array([1.0])
    for v in b_factors:
        b_full = np.kron(b_full, v)
    return np.linalg.solve(A_full, b_full)


def test_ragged_solve_matches_dense_oracle():
    rng = np.random.default_rng(7)
    sizes = (8, 12, 10)
    mats = [_lap(n, shift=1.0) for n in sizes]
    b_fac = [rng.standard_normal(n) for n in sizes]
    op, got_sizes = tkt.operator_from_ragged_factors(mats, symmetric=True, device="cpu")
    assert got_sizes == sizes and op.n == 12
    b = tkt.pad_ragged_rhs(b_fac, device="cpu")
    res = tkt.solve(op, b, tkt.SolverConfig(kmax=12, tol=1e-10))
    x_exact = _ragged_dense_solve(mats, b_fac)
    # the pad rows are dead to roundoff
    xf, w = res.x.factors.numpy(), res.x.weights.numpy()
    for s, ns in enumerate(sizes):
        if ns < xf.shape[1]:
            assert np.abs(xf[s, ns:, :]).max() < 1e-14
    x_cp = np.zeros_like(x_exact)
    for j in range(w.size):
        t = np.array([1.0])
        for s, ns in enumerate(sizes):
            t = np.kron(t, xf[s, :ns, j])
        x_cp += w[j] * t
    assert np.linalg.norm(x_cp - x_exact) / np.linalg.norm(x_exact) < 1e-7


def test_ragged_deflated_solve():
    """Deflation on a ragged operator: the U columns of the pad block are pad
    eigenvectors, but b⊥ is zero there, so they are inert; the same solve as
    the JAX package's (tests/test_ragged.py's case)."""
    rng = np.random.default_rng(3)
    sizes = (20, 14)
    mats = [_lap(n, shift=30.0) for n in sizes]
    b_fac = [rng.standard_normal(n) for n in sizes]
    op, _ = tkt.operator_from_ragged_factors(mats, symmetric=True, device="cpu")
    res = tkt.solve_deflated(op, tkt.pad_ragged_rhs(b_fac, device="cpu"), tkt.SolverConfig(kmax=14, tol=1e-9), m=4)
    x_exact = _ragged_dense_solve(mats, b_fac)
    xf, w = res.x.factors.numpy(), res.x.weights.numpy()
    x_cp = np.zeros_like(x_exact)
    for j in range(w.size):
        t = np.array([1.0])
        for s, ns in enumerate(sizes):
            t = np.kron(t, xf[s, :ns, j])
        x_cp += w[j] * t
    assert np.linalg.norm(x_cp - x_exact) / np.linalg.norm(x_exact) < 1e-6
    jop, _ = tk.operator_from_ragged_factors(mats, symmetric=True)
    ref = tk.solve_deflated(jop, tk.pad_ragged_rhs(b_fac), tk.SolverConfig(kmax=14, tol=1e-9), m=4)
    assert (res.status, res.niterations) == (int(ref.status), ref.niterations)
    np.testing.assert_allclose(res.certified_bound, ref.certified_bound, rtol=1e-10, atol=1e-15)
    np.testing.assert_allclose(xf, np.asarray(ref.x.factors), rtol=0, atol=1e-10)


def test_ragged_constructors_match_jax():
    rng = np.random.default_rng(3)
    sizes = (6, 9, 7)
    mats = [_lap(n, shift=2.0) for n in sizes]
    b_fac = [rng.standard_normal(n) for n in sizes]
    (op, s1), (jop, s2) = (tkt.operator_from_ragged_factors(mats, symmetric=True, device="cpu"),
                           tk.operator_from_ragged_factors(mats, symmetric=True))
    assert s1 == s2 and op.offsets == jop.offsets
    np.testing.assert_array_equal(op.bands.numpy(), np.asarray(jop.bands))
    np.testing.assert_array_equal(tkt.pad_ragged_rhs(b_fac, device="cpu").numpy(), np.asarray(tk.pad_ragged_rhs(b_fac)))
    np.testing.assert_array_equal(tkt.pad_ragged_rhs(b_fac, n_max=11, device="cpu").numpy(),
                                  np.asarray(tk.pad_ragged_rhs(b_fac, n_max=11)))
    with pytest.raises(ValueError, match="longer than n_max"):
        tkt.pad_ragged_rhs(b_fac, n_max=5, device="cpu")
    with pytest.raises(ValueError, match="not square"):
        tkt.operator_from_ragged_factors([np.ones((2, 3))], symmetric=True, device="cpu")


def test_ragged_pad_preserves_spectrum_extremes():
    sizes = (6, 9)
    mats = [_lap(n, shift=2.0) for n in sizes]
    op, _ = tkt.operator_from_ragged_factors(mats, symmetric=True, device="cpu")
    padded = tkt.bands_to_dense(op)
    for s, A in enumerate(mats):
        w_true, w_pad = np.linalg.eigvalsh(A), np.linalg.eigvalsh(padded[s])
        assert np.isclose(w_pad.min(), w_true.min()) and np.isclose(w_pad.max(), w_true.max())


@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_operator_from_scipy_matches_jax(fmt):
    rng = np.random.default_rng(11)
    n = 9
    mats = []
    for s in range(3):
        A = _lap(n, shift=float(s)) + np.diag(rng.standard_normal(n - 2), 2)
        mats.append(getattr(sp, f"{fmt}_matrix")(A))
    op, jop = (tkt.gallery.operator_from_scipy(mats, symmetric=False, device="cpu"),
               jgallery.operator_from_scipy(mats, symmetric=False))
    assert op.offsets == jop.offsets and not op.symmetric
    np.testing.assert_array_equal(op.bands.numpy(), np.asarray(jop.bands))
    np.testing.assert_array_equal(tkt.bands_to_dense(op), np.stack([m.toarray() for m in mats]))


def test_equal_size_constructors_reject_ragged():
    mats = [_lap(4), _lap(6)]
    with pytest.raises(ValueError, match="ragged"):
        tkt.operator_from_dense_factors(mats, symmetric=True, device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        tkt.gallery.operator_from_scipy([sp.csr_matrix(m) for m in mats], symmetric=True, device="cpu")


def test_laplace_eigenvectors_match_jax():
    n = 17
    V = eigen.laplace_eigenspace(n)
    np.testing.assert_allclose(V.numpy(), np.asarray(jeigen.laplace_eigenspace(n)), rtol=1e-14, atol=1e-15)
    for j in (1, 5, n):
        v = eigen.laplace_eigenvector(n, j)
        np.testing.assert_allclose(v.numpy(), np.asarray(jeigen.laplace_eigenvector(n, j)), rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(v.numpy(), V[:, j - 1].numpy(), rtol=1e-14, atol=1e-15)
    # the columns are the Laplacian's orthonormal eigenvectors
    A = _lap(n)
    lam = np.diag(V.numpy().T @ A @ V.numpy())
    np.testing.assert_allclose(A @ V.numpy(), V.numpy() * lam, atol=1e-9 * np.abs(lam).max())
    np.testing.assert_allclose(V.numpy().T @ V.numpy(), np.eye(n), atol=1e-13)
