"""The tridiagonal eigensolver, ops/eigen.py:masked_eigh_tridiag_mixed (on
the CPU its plain version, masked_eigh_tridiag_reference, then Newton–Schulz),
against the JAX package's masked_eigh_tridiag_mixed on the same numpy inputs,
and eigh_impl='tridiag_mixed' in the solvers against the JAX package's runs
and the port's dense runs.

Where eigenvalues cluster (Wilkinson's W21+, a plain-Lanczos T with ghost
copies, repeated blocks) the JAX function misses its own contract: on W21+ its
Q is 0.18 from orthonormal and its w 4e-7 off, on the ghost T its
reconstruction is 1.5e-7 off, because its f32 seed cannot tell the pairs
apart and Newton–Schulz cannot separate nearly parallel vectors. There the
port is held to LAPACK (numpy's eigh) at the same tolerances instead.
"""
import dataclasses
import functools
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu.ops import eigen as jeigen, expsum as jexpsum, orth as jorth
from tensorkrylov_tpu_torch.deflate import _resolve_eigh_impl
from tensorkrylov_tpu_torch.experiments import northstar as ns
from tensorkrylov_tpu_torch.interop import config_from_fields, operator_from_numpy, result_to_numpy
from tensorkrylov_tpu_torch.ops import _build, eigen
from tensorkrylov_tpu_torch.ops.eigen import (masked_eigh_tridiag_mixed, masked_eigh_tridiag_reference,
                                              tridiag_eigh)
from tensorkrylov_tpu_torch.ops.expsum import cp_solve_sym
from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_step
from tensorkrylov_tpu_torch.solver import auto_eigh_impl

torch.set_num_threads(1)


def _padded(T_blocks, K, seed=0):
    """(d, K, K) with the (k, k) symmetric tridiagonal blocks T_blocks (d, k, k)
    top left and symmetric junk elsewhere, which the active block must ignore."""
    d, k, _ = T_blocks.shape
    junk = np.random.default_rng(seed).standard_normal((d, K, K))
    H = junk + np.swapaxes(junk, 1, 2)
    H[:, :k, :] = 0.0
    H[:, :, :k] = 0.0
    H[:, :k, :k] = T_blocks
    H[:, k:, k - 1] = H[:, k - 1, k:] = 0.0  # no coupling stored past the block
    H[:, k:, k:] += np.diag(np.arange(K - k, dtype=float))
    return H


def _tridiag(diag, off):
    return np.stack([np.diag(a) + np.diag(b, 1) + np.diag(b, -1) for a, b in zip(diag, off)])


def _random(d, k, seed):
    rng = np.random.default_rng(seed)
    return _tridiag(rng.standard_normal((d, k)), rng.standard_normal((d, k - 1)))


@functools.lru_cache(maxsize=1)
def _jax_lanczos_H():
    """H after 12 reorthogonalized Lanczos steps of the JAX package at d=3,
    n=30 (K = 21): a T the solver really diagonalizes."""
    import jax

    jop, jb = tk.laplace(3, 30), tk.random_rhs(3, 30, seed=4, identical=False)
    st, _ = jorth.init_state(jop, jb, 20, jnp.float64)
    step = jax.jit(functools.partial(jorth.lanczos_step, reorth=True, proj_dtype=jnp.float64))
    for j in range(1, 13):
        st, _ = step(jop, st, jb, j)
    return np.asarray(st.H)


def _ghost_T():
    """60 plain Lanczos steps (orth='lanczos': no reorthogonalization) on a
    diagonal operator with outliers 4, 6, 10 above [1, 2]: orthogonality is
    lost and the outliers come back as ghosts, 10 five times, 6 four times,
    4 three times, each copy within 1e-15 relative of the others."""
    n, K = 200, 61
    lam = np.concatenate([np.linspace(1.0, 2.0, n - 3), [4.0, 6.0, 10.0]])
    op = tkt.KroneckerSumOperator(torch.tensor(lam[None, None, :]), (0,))
    b = torch.tensor(np.random.default_rng(3).standard_normal((1, n)))
    st, _ = init_state(op, b, K - 1, torch.float64)
    for k in range(1, K):
        st, _ = lanczos_step(op, st, b, k, reorth=False, proj_dtype=torch.float64)
    return st.H.numpy()[:, :K - 1, :K - 1]


def _wilkinson21():
    return _tridiag(np.abs(10.0 - np.arange(21.0))[None], np.ones((1, 20)))


def _zero_sub():
    """A T that decouples: zero sub-diagonal entries, as the lucky-breakdown
    restart of ops/orth.py leaves them."""
    T = _random(2, 12, 5)
    for s, i in ((0, 4), (1, 4), (1, 8)):
        T[s, i + 1, i] = T[s, i, i + 1] = 0.0
    return T


def _repeated_blocks():
    """Four equal decoupled 3×3 blocks: each eigenvalue four times exactly."""
    block = np.diag([2.0, 1.0, 3.0]) + np.diag([0.5, 0.5], 1) + np.diag([0.5, 0.5], -1)
    return np.kron(np.eye(4), block)[None]


def _flagship_like():
    """K = 513 (the flagship's kmax 512), k = 384: a perturbed 1-D Laplacian T."""
    rng = np.random.default_rng(8)
    return _tridiag(2.0 + 0.1 * rng.standard_normal((1, 384)), -np.ones((1, 383)))


# name: (a function making (H, k), whether its eigenvalues cluster)
CASES = {
    "random_k1": (lambda: (_padded(_random(3, 1, 1), 16), 1), False),
    "random_k8": (lambda: (_padded(_random(3, 8, 1), 16, 1), 8), False),
    "random_kK": (lambda: (_random(3, 16, 2), 16), False),
    "lanczos_k12": (lambda: (_jax_lanczos_H(), 12), False),
    "d1": (lambda: (_padded(_random(1, 6, 3), 9, 2), 6), False),
    "zero_subdiagonal": (lambda: (_padded(_zero_sub(), 14, 3), 12), False),
    "K513_k384": (lambda: (_padded(_flagship_like(), 513, 4), 384), False),
    "wilkinson21": (lambda: (_padded(_wilkinson21(), 24, 5), 21), True),
    "lanczos_ghosts": (lambda: (_padded(_ghost_T(), 62, 6), 60), True),
    "repeated_blocks": (lambda: (_padded(_repeated_blocks(), 13, 7), 12), True),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    H, k = CASES[name][0]()
    w, Q = masked_eigh_tridiag_mixed(torch.tensor(H), k)
    return H, k, w.numpy(), Q.numpy()


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(w, Q) to hold the port to: the JAX package's function, or on the
    clustered cases LAPACK's eigh of the active block, padded as the
    contract says."""
    H, k = CASES[name][0]()
    if not CASES[name][1]:
        w, Q = jeigen.masked_eigh_tridiag_mixed(jnp.asarray(H), k)
        return np.asarray(w), np.asarray(Q)
    d, K, _ = H.shape
    w, Q = np.zeros((d, K)), np.tile(np.eye(K), (d, 1, 1))
    for s in range(d):
        ws, Qs = np.linalg.eigh(H[s, :k, :k])
        w[s, :k], w[s, k:], Q[s, :k, :k] = ws, ws[0], Qs
    return w, Q


def _padded_target(H, k, w0):
    """The matrix whose eigendecomposition the contract returns: the active
    T, zero coupling, w[:, 0] on the padded diagonal."""
    d, K, _ = H.shape
    M = np.zeros_like(H)
    M[:, :k, :k] = H[:, :k, :k]
    M[:, np.arange(k, K), np.arange(k, K)] = w0[:, None]
    return M


@pytest.mark.parametrize("name", sorted(CASES))
def test_active_eigenvalues_match(name):
    """Ascending active eigenvalues within 1e-12·max|w| of the reference."""
    H, k, w, _ = _case(name)
    ref_w, _ = _reference(name)
    scale = np.abs(ref_w[:, :k]).max()
    np.testing.assert_allclose(w[:, :k], ref_w[:, :k], rtol=0, atol=1e-12 * scale)
    assert np.all(np.diff(w[:, :k], axis=1) >= 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_padded_slots_hold_the_active_minimum(name):
    """w[:, k:] equals w[:, :1], so the extremes over w are the active ones;
    Q's padded columns are the identity's."""
    H, k, w, Q = _case(name)
    K = H.shape[1]
    assert np.array_equal(w[:, k:], np.broadcast_to(w[:, :1], w[:, k:].shape))
    assert np.array_equal(Q[:, :, k:], np.broadcast_to(np.eye(K)[:, k:], Q[:, :, k:].shape))
    assert not Q[:, k:, :k].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_q_is_orthonormal(name):
    """QᵀQ = I to 1e-13, clusters included."""
    H, _, _, Q = _case(name)
    err = np.abs(np.swapaxes(Q, 1, 2) @ Q - np.eye(H.shape[1])).max()
    assert err <= 1e-13


@pytest.mark.parametrize("name", sorted(CASES))
def test_reconstruction(name):
    """Q diag(w) Qᵀ equals the masked T (w[:, 0] on the padded diagonal) to 1e-12·‖T‖."""
    H, k, w, Q = _case(name)
    M = _padded_target(H, k, w[:, 0])
    rec = Q @ (w[:, :, None] * np.swapaxes(Q, 1, 2))
    assert np.abs(rec - M).max() <= 1e-12 * np.abs(H[:, :k, :k]).max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_cp_solve_sym_matches(name):
    """The exp-sum factors exp(−γ_j T) b̃ through the port's cp_solve_sym and
    the JAX package's, each from its own eigenpairs: within 1e-10 relative."""
    H, k, w, Q = _case(name)
    ref_w, ref_Q = _reference(name)
    d, K, _ = H.shape
    rng = np.random.default_rng(9)
    btil = np.zeros((d, K))
    btil[:, :k] = rng.standard_normal((d, k))
    tmax = 8
    omega, alpha = rng.uniform(0.1, 1.0, tmax), rng.uniform(0.01, 2.0, tmax)
    t_mask = np.r_[np.ones(tmax - 2), np.zeros(2)]
    lam_min = float(np.abs(ref_w[:, :k]).max())
    weights, Y = cp_solve_sym(*map(torch.tensor, (w, Q, btil)), k, *map(torch.tensor, (omega, alpha, t_mask)),
                              torch.tensor(lam_min, dtype=torch.float64))
    jweights, jY = jexpsum.cp_solve_sym(*map(jnp.asarray, (ref_w, ref_Q, btil)), k,
                                        *map(jnp.asarray, (omega, alpha, t_mask)), jnp.asarray(lam_min))
    np.testing.assert_allclose(weights.numpy(), np.asarray(jweights), rtol=1e-15)
    jY = np.asarray(jY)
    assert np.abs(Y.numpy() - jY).max() <= 1e-10 * np.abs(jY).max()


@pytest.mark.parametrize("name", ["random_kK", "lanczos_k12", "wilkinson21", "lanczos_ghosts"])
def test_one_inverse_iteration_solve(name):
    """refine_vectors=False (a basis below f64) runs one inverse-iteration
    solve: the same eigenvalues, and still orthonormal to 1e-13 with the
    reconstruction to 1e-12·‖T‖."""
    H, k = CASES[name][0]()
    w, Q = (x.numpy() for x in masked_eigh_tridiag_mixed(torch.tensor(H), k, refine_vectors=False))
    _, _, w2, _ = _case(name)
    assert np.array_equal(w, w2)
    assert np.abs(np.swapaxes(Q, 1, 2) @ Q - np.eye(H.shape[1])).max() <= 1e-13
    rec = Q @ (w[:, :, None] * np.swapaxes(Q, 1, 2))
    assert np.abs(rec - _padded_target(H, k, w[:, 0])).max() <= 1e-12 * np.abs(H[:, :k, :k]).max()


def test_jax_refine_false_eigenvalues_agree():
    """With refine_vectors=False on both sides the eigenvalues still agree:
    the JAX package's f32-seed Rayleigh quotients are within 1e-12·max|w|."""
    H = _jax_lanczos_H()
    w, _ = masked_eigh_tridiag_mixed(torch.tensor(H), 12, refine_vectors=False)
    jw, _ = jeigen.masked_eigh_tridiag_mixed(jnp.asarray(H), 12, refine_vectors=False)
    jw = np.asarray(jw)
    np.testing.assert_allclose(w.numpy()[:, :12], jw[:, :12], rtol=0, atol=1e-12 * np.abs(jw).max())


def test_clusters_need_their_gram_schmidt(monkeypatch):
    """Why the cluster rule: with no cluster (TRIDIAG_CLUSTER_RTOL = 0 joins
    only exactly equal eigenvalues), W21+'s top pairs, 7e-14 apart, get
    vectors 4e-3 from orthogonal, and after Newton–Schulz the reconstruction
    is still 9e-10 off, far outside the contract's 1e-12·‖T‖."""
    H, k = CASES["wilkinson21"][0]()
    monkeypatch.setattr(eigen, "TRIDIAG_CLUSTER_RTOL", 0.0)
    _, Q0 = tridiag_eigh(torch.tensor(H), k)
    Q0 = Q0.numpy()
    assert np.abs(np.swapaxes(Q0, 1, 2) @ Q0 - np.eye(H.shape[1])).max() > 1e-3
    w, Q = (x.numpy() for x in masked_eigh_tridiag_mixed(torch.tensor(H), k))
    rec = Q @ (w[:, :, None] * np.swapaxes(Q, 1, 2))
    assert np.abs(rec - _padded_target(H, k, w[:, 0])).max() > 1e-11 * np.abs(H[:, :k, :k]).max()


def test_zero_matrix_has_no_nan():
    """A zero active block (every eigenvalue 0, one cluster of k): no NaN,
    the identity's eigenpairs."""
    H = np.zeros((2, 6, 6))
    w, Q = (x.numpy() for x in masked_eigh_tridiag_mixed(torch.tensor(H), 4))
    assert not w.any()
    np.testing.assert_allclose(np.swapaxes(Q, 1, 2) @ Q, np.broadcast_to(np.eye(6), Q.shape), atol=1e-15)


def test_f32():
    """In f32 (proj_dtype=float32) the same arithmetic at f32's epsilon:
    eigenvalues within 1e-5 relative of f64's, Q orthonormal to 1e-6."""
    H, k = CASES["lanczos_k12"][0]()
    w, Q = masked_eigh_tridiag_mixed(torch.tensor(H, dtype=torch.float32), k)
    _, _, w64, _ = _case("lanczos_k12")
    np.testing.assert_allclose(w.numpy()[:, :k], w64[:, :k], rtol=0, atol=1e-5 * np.abs(w64).max())
    Qn = Q.double().numpy()
    assert np.abs(np.swapaxes(Qn, 1, 2) @ Qn - np.eye(H.shape[1])).max() <= 1e-6


def test_cpu_takes_the_plain_version():
    """A CPU tensor goes through masked_eigh_tridiag_reference, bit for bit,
    and launches nothing; another device raises."""
    H, k = CASES["zero_subdiagonal"][0]()
    launches = dict(_build.launches)
    got = tridiag_eigh(torch.tensor(H), k)
    ref = masked_eigh_tridiag_reference(torch.tensor(H), k)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert dict(_build.launches) == launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        tridiag_eigh(torch.zeros((1, 4, 4), device="meta"), 2)


def test_start_vectors_exact_and_distinct():
    """Hashed start vectors in [-0.5, 0.5), equal in f32 and f64 (24-bit
    values), one distinct column per eigenvalue."""
    s64 = eigen._start_vectors(40, torch.float64, "cpu")
    s32 = eigen._start_vectors(40, torch.float32, "cpu")
    assert torch.equal(s64, s32.double())
    assert float(s64.min()) >= -0.5 and float(s64.max()) < 0.5
    assert torch.linalg.matrix_rank(s64) == 40


def test_tree_sum_is_the_kernel_order():
    """_tree_sum adds entry i + ⌈len/2⌉ to entry i until one is left."""
    x = torch.tensor(np.random.default_rng(2).standard_normal(11))
    v = x.tolist()
    n = len(v)
    while n > 1:
        half = (n + 1) // 2
        for i in range(n - half):
            v[i] = v[i] + v[i + half]
        n = half
    assert float(eigen._tree_sum(x)[0]) == v[0]


# --------------------------------------------------------------------------
# the solvers with eigh_impl='tridiag_mixed'


def _laplace_problem(seed=22):
    jop, jb = tk.laplace(3, 30), tk.random_rhs(3, 30, seed=seed)
    jb = jb / jnp.linalg.norm(jb, axis=1, keepdims=True)
    return jop, jb, operator_from_numpy(np.asarray(jop.bands), jop.offsets), torch.tensor(np.asarray(jb))


def _port_config(jcfg):
    return config_from_fields({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def test_tridiag_mixed_solve_matches_dense():
    """Twin of tests/test_solver.py::test_tridiag_mixed_eigh_solve_matches_dense:
    the same status and steps as the dense eigh, the trace to 1e-7, the dense
    oracle below 1e-8."""
    _, _, op, b = _laplace_problem()
    r_dense = tkt.solve(op, b, tkt.SolverConfig(kmax=30, tol=1e-8, eigh_impl="dense"))
    r_mixed = tkt.solve(op, b, tkt.SolverConfig(kmax=30, tol=1e-8, eigh_impl="tridiag_mixed"))
    assert r_mixed.config.eigh_impl == "tridiag_mixed" and r_dense.config.eigh_impl == "dense"
    assert r_mixed.status == r_dense.status
    ni = r_dense.niterations
    assert r_mixed.niterations == ni
    np.testing.assert_allclose(r_mixed.relative_residual[1:ni + 1].numpy(), r_dense.relative_residual[1:ni + 1].numpy(),
                               rtol=1e-7)
    assert tkt.kron_residual_dense(op, r_mixed.x, b) < 1e-8


MODES = {
    "lanczos": dict(orth="lanczos"),
    "lanczos_reorth": dict(orth="lanczos_reorth"),
    "lanczos_reorth_auto": dict(orth="lanczos_reorth_auto"),
    "fused": dict(orth="lanczos_reorth_auto", step_impl="fused"),
    "check_every_4": dict(check_every=4),
    "identical_factors": dict(identical_factors=True),
    "A_minor": dict(spectral_source="A_minor"),
    "analytic_laplace": dict(spectral_source="analytic_laplace"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tridiag_mixed_solve_matches_jax(mode):
    """eigh_impl='tridiag_mixed' on both sides at d=3, n=30: the same status,
    steps and exp-sum ranks, the trace to 1e-6 and the spectra to 1e-10 (the
    tolerances of tests/test_torch_solve.py::test_solve_matches_jax)."""
    fields = MODES[mode]
    jop, jb, op, b = _laplace_problem(7)
    if fields.get("identical_factors"):
        jb = jnp.broadcast_to(jb[:1], jb.shape)
        b = b[:1].expand_as(b).clone()
    jcfg = tk.SolverConfig(kmax=30, tol=1e-8, eigh_impl="tridiag_mixed", **fields)
    ref = tk.solve(jop, jb, jcfg)
    res = tkt.solve(op, b, _port_config(jcfg))
    assert res.config.eigh_impl == "tridiag_mixed"
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations))
    k = res.niterations
    got = result_to_numpy(res)
    checked = np.isfinite(np.asarray(ref.relative_residual)[1:k + 1])
    np.testing.assert_allclose(got["relative_residual"][1:k + 1][checked],
                               np.asarray(ref.relative_residual)[1:k + 1][checked], rtol=1e-6)
    for f in ("lambda_min", "lambda_max"):
        np.testing.assert_allclose(got[f][1:k + 1], np.asarray(getattr(ref, f))[1:k + 1], rtol=1e-10)
    np.testing.assert_array_equal(got["expsum_rank"], np.asarray(ref.expsum_rank))


def test_host_projected_tridiag_mixed_matches_dense():
    """solve_host_projected with an explicit 'tridiag_mixed' runs the plain
    version on the host: the dense run's status and steps, the trace to 1e-7."""
    _, _, op, b = _laplace_problem()
    cfg = dict(kmax=30, tol=1e-8, check_every=4)
    dense = tkt.solve_host_projected(op, b, tkt.SolverConfig(**cfg))
    mixed = tkt.solve_host_projected(op, b, tkt.SolverConfig(eigh_impl="tridiag_mixed", **cfg))
    assert dense.config.eigh_impl == "dense" and mixed.config.eigh_impl == "tridiag_mixed"
    assert (mixed.status, mixed.niterations) == (dense.status, dense.niterations)
    idx = np.flatnonzero(np.isfinite(dense.relative_residual.numpy()) & (dense.relative_residual.numpy() > 0))
    np.testing.assert_allclose(mixed.relative_residual.numpy()[idx], dense.relative_residual.numpy()[idx], rtol=1e-7)


def test_auto_resolves_dense_on_the_cpu():
    """Every CPU run resolves 'auto' to the dense eigh, in solve and solve_deflated."""
    _, _, op, b = _laplace_problem()
    assert tkt.solve(op, b, tkt.SolverConfig(kmax=4, tol=1e-8)).config.eigh_impl == "dense"
    assert _resolve_eigh_impl(tkt.SolverConfig(), op) == "dense"


@pytest.mark.parametrize("device_type,symmetric,orth,host_projected,want", [
    ("cuda", True, "lanczos_reorth", False, "tridiag_mixed"),
    ("cuda", True, "lanczos", False, "tridiag_mixed"),
    ("cuda", True, "lanczos_reorth_auto", False, "tridiag_mixed"),
    ("cuda", True, "arnoldi", False, "dense"),
    ("cuda", False, "arnoldi", False, "dense"),
    ("cuda", True, "lanczos_reorth", True, "dense"),
    ("cpu", True, "lanczos_reorth", False, "dense"),
])
def test_auto_eigh_impl_rule(device_type, symmetric, orth, host_projected, want):
    """JAX solver.py:440-447 with "on the TPU" read as "on a CUDA device"."""
    assert auto_eigh_impl(device_type, symmetric, orth, host_projected) == want


@pytest.mark.parametrize("device,requested,want", [
    ("cuda", "auto", "tridiag_mixed"), ("cpu", "auto", "dense"), ("cuda", "dense", "dense"),
    ("cpu", "tridiag_mixed", "tridiag_mixed"), ("cuda", "host", "host"),
])
def test_deflated_auto_rule(device, requested, want):
    """JAX deflate.py:784-786 with the same reading; an explicit choice stays."""
    op = types.SimpleNamespace(device=torch.device(device))
    assert _resolve_eigh_impl(tkt.SolverConfig(eigh_impl=requested), op) == want


def test_block_tridiag_mixed_runs_dense():
    """Block H is block-tridiagonal: solve_block takes 'tridiag_mixed' as
    'dense' (JAX block.py:305-307), the dense run bit for bit."""
    op = tkt.laplace(2, 30, device="cpu")
    B = torch.tensor(np.random.default_rng(4).standard_normal((2, 2, 30)))
    dense = tkt.solve_block(op, B, tkt.SolverConfig(kmax=12, tol=1e-9, eigh_impl="dense"))
    mixed = tkt.solve_block(op, B, tkt.SolverConfig(kmax=12, tol=1e-9, eigh_impl="tridiag_mixed"))
    assert mixed.config.eigh_impl == "dense"
    assert (mixed.status, mixed.niterations) == (dense.status, dense.niterations)
    assert torch.equal(mixed.relative_residual, dense.relative_residual)
    assert torch.equal(mixed.x.factors, dense.x.factors)


@functools.lru_cache(maxsize=None)
def _deflated(impl, package):
    if package == "jax":
        op, b = tk.laplace(3, 30, shift=50.0), tk.random_rhs(3, 30, seed=7)
        r = tk.solve_deflated(op, b, tk.SolverConfig(kmax=30, tol=1e-7, eigh_impl=impl), m=6,
                              checkpoints=[8, 16, 24], certify=False)
        return r, op, np.asarray(b)
    op, b = tkt.laplace(3, 30, shift=50.0, device="cpu"), tkt.random_rhs(3, 30, seed=7)
    r = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=30, tol=1e-7, eigh_impl=impl), m=6,
                           checkpoints=[8, 16, 24], certify=False)
    return r, op, b


def test_deflated_tridiag_mixed_matches_dense():
    """Twin of tests/test_deflate.py::test_deflated_eigh_impl_tridiag_mixed_matches_dense:
    the checkpoint algebra through the tridiagonal eigensolver gives the
    dense run's status, its bounds to 1e-9 and its x to 1e-10, and the dense
    oracle sits below the bound."""
    r_d, op, b = _deflated("dense", "port")
    r_m, _, _ = _deflated("tridiag_mixed", "port")
    assert r_m.status == r_d.status
    np.testing.assert_allclose(r_m.certified_bound, r_d.certified_bound, rtol=1e-9)
    np.testing.assert_allclose(r_m.x.factors.numpy(), r_d.x.factors.numpy(), atol=1e-10)
    assert float(tkt.kron_residual_dense(op, r_m.x, b)) <= r_m.certified_bound[-1] + 1e-12


def test_deflated_tridiag_mixed_matches_jax():
    """The same solve in both packages with eigh_impl='tridiag_mixed': the
    checkpoints, status, bounds to 1e-9 and x to 1e-10."""
    r, _, _ = _deflated("tridiag_mixed", "port")
    j, _, _ = _deflated("tridiag_mixed", "jax")
    assert (r.status, r.niterations, r.checkpoints) == (int(j.status), int(j.niterations), list(j.checkpoints))
    np.testing.assert_allclose(r.certified_bound, j.certified_bound, rtol=1e-9)
    np.testing.assert_allclose(r.x.factors.numpy(), np.asarray(j.x.factors), atol=1e-10)


def test_northstar_records_the_resolved_eigh(tmp_path):
    """The runner's artifact records what the solver ran: 'dense' for 'auto'
    on the CPU, 'tridiag_mixed' when asked, with the same bounds to 1e-9."""
    argv = ["--cpu", "--d", "2", "--n", "64", "--m", "4", "--kappa", "1e2", "--kmax", "24", "--checkpoints", "12",
            "24", "--basis-cache", "none"]
    arts = {}
    for impl in ("auto", "tridiag_mixed"):
        out = tmp_path / f"{impl}.json"
        ns.main(argv + ["--eigh-impl", impl, "--out", str(out)])
        with open(out) as fh:
            arts[impl] = json.load(fh)
    assert arts["auto"]["recipe"]["eigh_impl_resolved"] == "dense"
    assert arts["tridiag_mixed"]["recipe"]["eigh_impl_resolved"] == "tridiag_mixed"
    np.testing.assert_allclose(arts["tridiag_mixed"]["result"]["certified_bound"],
                               arts["auto"]["result"]["certified_bound"], rtol=1e-9)


def test_a_failed_launch_raises(monkeypatch):
    """The CUDA path never falls back to the plain version or to the dense
    eigh: an entry point that reports a CUDA error raises, naming the kernel."""
    seen = []

    def failing(*args):
        seen.append(args)
        return 700  # cudaErrorIllegalAddress

    lib = types.SimpleNamespace(tk_tridiag_eigh_f64=failing, tk_tridiag_eigh_f32=failing)
    monkeypatch.setattr(_build, "kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    launches = dict(_build.launches)
    H = torch.tensor(_random(2, 5, 1))
    monkeypatch.setattr(eigen, "tridiag_cluster", lambda d, k, P, dtype, device: 4)
    with pytest.raises(RuntimeError, match="tridiag_eigh failed to launch"):
        eigen._tridiag_eigh_cuda(H, 5, True)
    with pytest.raises(RuntimeError, match="tridiag_eigh failed to launch"):
        eigen._tridiag_eigh_cuda(H.float(), 4, False, lanes=8, cluster=2)
    # (d, K, k, lanes P, rounds, solves, blocks per cluster G): the plan's G, or the one forced
    assert len(seen) == 2 and seen[0][4:11] == (2, 5, 5, 32, 13, 2, 4) and seen[1][4:11] == (2, 5, 4, 8, 22, 1, 2)
    assert seen[0][11:14] == (torch.finfo(torch.float64).eps, torch.finfo(torch.float64).tiny * 1e8,
                              eigen.TRIDIAG_CLUSTER_RTOL)
    assert dict(_build.launches) == launches


# --------------------------------------------------------------------------
# multisection: the rules the kernel and its plain version share


def test_selection_keeps_the_bracket_on_non_monotone_counts():
    """_multisection_select on hand-made counts that are not monotone in x:
    the first probe above j is the new hi and the one before it the new lo,
    so count(lo) <= j < count(hi) holds. Taking the count of probes at or
    below j as the index would pick x[1], whose count 3 exceeds j = 2."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    lo, hi, j = torch.tensor(0.0), torch.tensor(5.0), torch.tensor(2)
    new_lo, new_hi = eigen._multisection_select(lo, hi, x, torch.tensor([1, 3, 2, 4]), j)
    assert (float(new_lo), float(new_hi)) == (1.0, 2.0)
    new_lo, new_hi = eigen._multisection_select(lo, hi, x, torch.tensor([3, 1, 2, 4]), j)
    assert (float(new_lo), float(new_hi)) == (0.0, 1.0)
    new_lo, new_hi = eigen._multisection_select(lo, hi, x, torch.tensor([2, 0, 1, 2]), j)
    assert (float(new_lo), float(new_hi)) == (4.0, 5.0)
    # random non-monotone counts, batched: the invariant with count(lo) <= j < count(hi) given
    rng = np.random.default_rng(6)
    n, probes = 4000, 15
    counts = torch.tensor(rng.integers(0, 12, (n, probes)))
    j = torch.tensor(rng.integers(0, 11, n))
    xs = torch.tensor(np.sort(rng.uniform(1.0, 2.0, (n, probes)), axis=1))
    lo, hi = torch.zeros(n, dtype=torch.float64), torch.full((n,), 3.0, dtype=torch.float64)
    new_lo, new_hi = eigen._multisection_select(lo, hi, xs, counts, j)
    at = {float(v): c for row_x, row_c in zip(xs.tolist(), counts.tolist()) for v, c in zip(row_x, row_c)}
    for a, b, jj in zip(new_lo.tolist(), new_hi.tolist(), j.tolist()):
        assert a < b
        assert (a == 0.0 or at[a] <= jj) and (b == 3.0 or at[b] > jj)


@pytest.mark.parametrize("d", [1, 2, 10, 64])
def test_lanes_rule(d):
    """P is a power of two in 2..32, the largest with d·k·P within
    TRIDIAG_LANES (2 when none is); its rounds cover TRIDIAG_BISECT_ITERS
    halvings and one round fewer would not."""
    for k in list(range(1, 70)) + [128, 200, 201, 384, 512, 1000, 4096]:
        P = eigen.tridiag_lanes(d, k)
        bits = P.bit_length() - 1
        assert P in (2, 4, 8, 16, 32)
        assert P == 2 or d * k * P <= eigen.TRIDIAG_LANES
        assert P == 32 or d * k * 2 * P > eigen.TRIDIAG_LANES
        rounds = eigen.tridiag_rounds(P)
        assert rounds * bits >= eigen.TRIDIAG_BISECT_ITERS > (rounds - 1) * bits
    shapes = ((10, 29), (1, 29), (10, 200), (10, 384), (10, 512))
    assert [eigen.tridiag_lanes(*dk) for dk in shapes] == [32, 32, 16, 8, 4]
    with pytest.raises(ValueError, match="power of two"):
        eigen._tridiag_rules(torch.float64, True, d, 4, lanes=12)


def _tridiag_parts(T):
    d, k, _ = T.shape
    diag = torch.tensor(T[:, np.arange(k), np.arange(k)])
    off = torch.tensor(np.concatenate([np.zeros((d, 1)), T[:, np.arange(1, k), np.arange(k - 1)]], axis=1))
    return diag, off


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("lanes", [None, 2, 4, 16])
def test_multisection_agrees_with_bisection_and_lapack(name, lanes):
    """The plain multisection's eigenvalues (the rule's P, or P forced)
    against tridiag_eigvalsh_sturm's 80 halvings to 2 ulps of ‖T‖, and against
    LAPACK's eigvalsh of the active block to 2·k ulps of ‖T‖."""
    H, k = CASES[name][0]()
    w, _ = masked_eigh_tridiag_reference(torch.tensor(H), k, lanes=lanes)
    w = w.numpy()[:, :k]
    T = H[:, :k, :k]
    norm = np.abs(T).sum(axis=2).max()
    ulp = np.finfo(np.float64).eps * norm
    bisect = eigen.tridiag_eigvalsh_sturm(*_tridiag_parts(T)).numpy()
    assert np.abs(w - bisect).max() <= 2 * ulp
    lapack = np.stack([np.linalg.eigvalsh(t) for t in T])
    assert np.abs(w - lapack).max() <= 2 * k * ulp


@pytest.mark.parametrize("name", ["random_kK", "lanczos_k12", "wilkinson21", "lanczos_ghosts", "K513_k384"])
def test_halvings_count_bisection_equivalent_work(name):
    """stats: `halvings` is log₂P per live round and `probes` (P − 1) per live
    round, summed over eigenvalues; with P = 2 both are bisection's halvings,
    and at the rule's P the halvings stay within one round an eigenvalue of
    them, so a bound that reads `halvings` does not grow with the probes."""
    H, k = CASES[name][0]()
    d = H.shape[0]
    runs = {}
    for lanes in (2, None):
        stats = {}
        masked_eigh_tridiag_reference(torch.tensor(H), k, stats=stats, lanes=lanes)
        runs[lanes] = stats
    P = runs[None]["lanes"]
    assert P == eigen.tridiag_lanes(d, k) and runs[2]["lanes"] == 2
    assert runs[2]["halvings"] == runs[2]["probes"] <= d * k * eigen.TRIDIAG_BISECT_ITERS
    live_rounds, rest = divmod(runs[None]["halvings"], P.bit_length() - 1)
    assert rest == 0 and runs[None]["probes"] == (P - 1) * live_rounds
    assert live_rounds <= d * k * runs[None]["rounds"]
    assert abs(runs[None]["halvings"] - runs[2]["halvings"]) < d * k * (P.bit_length() - 1)


@pytest.mark.parametrize("name", ["random_k8", "zero_subdiagonal", "wilkinson21", "K513_k384"])
def test_newton_schulz_on_the_active_block(name):
    """The two Newton–Schulz steps on Q[:, :k, :k] equal the padded (d, K, K)
    product's: the identity columns and zero blocks exactly, the active
    block up to GEMM summation order (1e-15)."""
    H, k = CASES[name][0]()
    Ht = torch.tensor(H)
    _, Q = tridiag_eigh(Ht, k)
    for _ in range(2):
        Q = 1.5 * Q - 0.5 * (Q @ (Q.transpose(1, 2) @ Q))
    _, got = masked_eigh_tridiag_mixed(Ht, k)
    K = H.shape[1]
    assert torch.equal(got[:, :, k:], torch.eye(K, dtype=got.dtype)[:, k:].expand(H.shape[0], K, K - k))
    assert not got[:, k:, :k].any()
    assert float((got - Q).abs().max()) <= 1e-15
