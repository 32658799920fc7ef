"""The port's block (global) Krylov solve and the rank-R block Lemma 3.4 on
the CPU: against the JAX package on the same numpy inputs, the dense
Kronecker oracle, and the port's own scalar Arnoldi solve (tests/test_block.py's
cases)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu.ops import gram as jgram
from tensorkrylov_tpu_torch.ops import gram

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)

TRACE_RTOL = 1e-10  # f64 traces of the two packages (CGS2 keeps them within ~1e-13 here)
# The nonsymmetric case's compressed residual sits at the cancellation floor
# (64·eps·(‖Hy‖² + ‖b̃‖²)) at most checks, where projected_step takes
# r_comp² + floor: a rounding of eps·scale in r_comp² moves that by 1/64 of it
FLOOR_RTOL = 1.0 / 64
FIELDS = ("relative_residual", "lambda_min", "lambda_max")


def _rand_block(R, d, n, seed):
    B = np.random.default_rng(seed).standard_normal((R, d, n))
    return B / np.linalg.norm(B, axis=2, keepdims=True)


def _dense_true_rel(op, B, x):
    """‖A x − b‖/‖b‖ with the whole rank-R b materialized (d ≤ 3, n ≤ 40)."""
    d = B.shape[1]
    bfull = 0
    for r in range(B.shape[0]):
        v = B[r, 0]
        for s in range(1, d):
            v = np.kron(v, B[r, s])
        bfull = bfull + v
    return np.linalg.norm(tkt.kron_matvec_dense(op, tkt.cp_full(x)) - bfull) / np.linalg.norm(bfull)


@pytest.mark.parametrize("R", [1, 2, 3])
def test_residual_norm_sq_block_matches_jax(R):
    """The block Lemma 3.4 (b̃ (d, K, R), boundary blocks (d, R, R)) to 1e-12."""
    rng = np.random.default_rng(40 + R)
    d, K, T, k = 3, 13, 10, 9
    H, Y = rng.standard_normal((d, K, K)), rng.standard_normal((d, K, T))
    btil, w, sub = rng.standard_normal((d, K, R)), rng.standard_normal(T), rng.standard_normal((d, R, R))
    ref = jax.jit(jgram.residual_norm_sq, static_argnums=3)(*map(jnp.asarray, (H, Y, btil)), k, jnp.asarray(w),
                                                           jnp.asarray(sub))
    got = gram.residual_norm_sq(*map(torch.tensor, (H, Y, btil)), k, torch.tensor(w), torch.tensor(sub))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)
    if R == 1:
        # the rank-1 form (b̃ (d, K), subdiagonal (d,)) is the same sum by its own code
        one = gram.residual_norm_sq(*map(torch.tensor, (H, Y, btil[:, :, 0])), k, torch.tensor(w),
                                    torch.tensor(sub[:, 0, 0]))
        for g, o in zip(got, one):
            np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=1e-14)


# name: (gallery, d, n, R, seed, config fields); the cases of tests/test_block.py
CASES = {
    "spd": ("laplace", 2, 30, 3, 5, dict(kmax=18, tol=1e-9, check_every=1)),
    "nonsym": ("conv_diff", 2, 24, 2, 6, dict(kmax=12, tol=1e-6, orth="arnoldi", tmax=151, check_every=1)),
    "duplicate_rhs": ("laplace", 2, 24, 2, 7, dict(kmax=12, tol=1e-9, check_every=1)),
    "r1_arnoldi": ("laplace", 2, 20, 1, 8, dict(kmax=20, tol=1e-9, orth="arnoldi", check_every=1)),
    "kmax_clamped": ("laplace", 2, 20, 3, 9, dict(kmax=50, tol=1e-12, check_every=1)),
}
SLOW = ("spd", "r1_arnoldi", "kmax_clamped")  # their JAX twins are marked slow in tests/test_block.py


def _case(name):
    gal, d, n, R, seed, fields = CASES[name]
    B = _rand_block(R, d, n, seed)
    if name == "duplicate_rhs":  # linearly dependent block columns
        B = np.stack([B[0], B[0]])
    return gal, d, n, B, fields


def _port(name):
    gal, d, n, B, fields = _case(name)
    op = getattr(tkt, gal)(d, n, device="cpu")
    return op, B, tkt.solve_block(op, torch.tensor(B), tkt.SolverConfig(**fields))


@pytest.mark.parametrize("name", [pytest.param(c, marks=pytest.mark.slow) if c in SLOW else c for c in CASES])
def test_solve_block_matches_jax(name):
    gal, d, n, B, fields = _case(name)
    ref = tk.solve_block(getattr(tk, gal)(d, n), B, tk.SolverConfig(**fields))
    _, _, res = _port(name)
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations))
    k = res.niterations
    checked = np.isfinite(np.asarray(ref.relative_residual))
    for f in FIELDS:
        got, want = getattr(res, f).numpy(), np.asarray(getattr(ref, f))
        rtol = FLOOR_RTOL if (name, f) == ("nonsym", "relative_residual") else TRACE_RTOL
        np.testing.assert_allclose(got[checked], want[checked], rtol=rtol, err_msg=f)
    np.testing.assert_array_equal(res.expsum_rank.numpy(), np.asarray(ref.expsum_rank))
    full, jfull = tkt.cp_full(res.x), np.asarray(tk.cp_full(ref.x))
    assert np.abs(full - jfull).max() <= 1e-9 * np.abs(jfull).max(), k


@pytest.mark.parametrize("name,limit", [("spd", 1e-8), ("nonsym", 1e-6), ("duplicate_rhs", 1e-8)])
def test_solve_block_dense_oracle(name, limit):
    """Converged, the dense residual of the rank-R system below tol, and the
    certified estimate at least half the true residual."""
    op, B, res = _port(name)
    assert res.status == tkt.Status.CONVERGED
    true_rel = _dense_true_rel(op, B, res.x)
    assert true_rel < limit
    if name == "spd":
        assert float(res.relative_residual[res.niterations]) >= 0.5 * true_rel


def test_block_r1_matches_scalar_arnoldi():
    """R = 1 is scalar CGS2 Arnoldi: the traces of the port's solve agree."""
    op, B, blk = _port("r1_arnoldi")
    sca = tkt.solve(op, torch.tensor(B[0]), tkt.SolverConfig(**CASES["r1_arnoldi"][5]))
    k = sca.niterations
    assert blk.niterations == k
    np.testing.assert_allclose(blk.relative_residual[1:k + 1].numpy(), sca.relative_residual[1:k + 1].numpy(),
                               rtol=1e-8)


def test_block_kmax_clamped_to_space():
    """kmax·R is clamped to the factor dimension n: no junk iterations."""
    _, _, res = _port("kmax_clamped")
    assert res.config.kmax == 20 // 3 and res.niterations <= 20 // 3
    assert np.all(np.isfinite(res.relative_residual[1:res.niterations + 1].numpy()))


def test_block_shares_subspace():
    """The shared subspace needs no more block steps than the worst of the
    independent rank-1 solves needs steps."""
    op = tkt.laplace(2, 30, device="cpu")
    B = torch.tensor(_rand_block(2, 2, 30, 10))
    cfg = tkt.SolverConfig(kmax=30, tol=1e-8, check_every=1)
    blk = tkt.solve_block(op, B, cfg)
    _, ind = tkt.solve_multi_rhs(op, B, cfg)
    assert blk.status == tkt.Status.CONVERGED
    assert blk.niterations <= int(ind.niterations.max()) + 1


def test_block_one_spmv_per_step_and_telemetry(monkeypatch):
    """Every block step is one SpMV of the (d, R, n) block; the drift probe
    is recorded at every step, the residual at every check."""
    from tensorkrylov_tpu_torch.ops import banded

    op = tkt.laplace(2, 30, device="cpu")
    B = torch.tensor(_rand_block(3, 2, 30, 5))
    calls = []
    real = banded.spmv_reference
    monkeypatch.setattr(banded, "spmv_reference", lambda o, v: calls.append(tuple(v.shape)) or real(o, v))
    res = tkt.solve_block(op, B, tkt.SolverConfig(kmax=18, tol=1e-9, check_every=4))
    k = res.niterations
    assert calls == [(2, 3, 30)] * k
    assert tuple(res.x.factors.shape) == (2, 30, 63 * 3)
    checked = np.flatnonzero(np.isfinite(res.relative_residual.numpy()))
    assert list(checked) == [j for j in range(1, k + 1) if j % 4 == 0 or j == k]
    assert np.all(res.orthogonality[1:k + 1].numpy() < 1e-10)


def test_solve_block_rejects_bad_input():
    op = tkt.laplace(2, 16, device="cpu")
    B = torch.tensor(_rand_block(2, 2, 16, 1))
    with pytest.raises(ValueError, match=r"B must be \(R, d, n\)"):
        tkt.solve_block(op, B[0])
    with pytest.raises(ValueError, match="spectral_source"):
        tkt.solve_block(op, B, tkt.SolverConfig(spectral_source="analytic_laplace"))
    with pytest.raises(ValueError, match="orth='arnoldi'"):
        tkt.solve_block(tkt.conv_diff(2, 16, device="cpu"), B)
