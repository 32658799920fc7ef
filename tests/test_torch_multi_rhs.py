"""The port's solve_multi_rhs and solve_resumable on the CPU: against the JAX
package's on the same inputs, the dense oracle, and bit-equality of the
segmented, checkpointed and resumed solve with solve()."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu.solver import solve_resumable as jax_solve_resumable
from tensorkrylov_tpu_torch.solver import _segment, _setup
from tensorkrylov_tpu_torch.utils.checkpoint import load_carry, save_carry

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)

TRACE_RTOL = 1e-10  # the packages' traces agree to ~1e-12 at these sizes
FIELDS = ("relative_residual", "projected_residual", "lambda_min", "lambda_max")


def _rank2():
    d, n, R = 3, 20, 2
    B = np.random.default_rng(21).standard_normal((R, d, n))
    return tkt.laplace(d, n, device="cpu"), B


@pytest.fixture(scope="module")
def multi():
    """The JAX package's and the port's rank-2 solve (d=3, n=20, R=2; the JAX
    one vmaps its while-loop, ~2 s to compile on the CPU)."""
    op, B = _rank2()
    cfg = dict(kmax=20, tol=1e-8)
    return tk.solve_multi_rhs(tk.laplace(3, 20), B, tk.SolverConfig(**cfg)), \
        tkt.solve_multi_rhs(op, torch.tensor(B), tkt.SolverConfig(**cfg))


def test_multi_rhs_matches_jax(multi):
    (jx, jres), (x, res) = multi
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(res.niterations.numpy(), np.asarray(jres.niterations))
    for f in FIELDS:
        a, r = getattr(res, f).numpy(), np.asarray(getattr(jres, f))
        assert a.shape == r.shape == (2, 21)
        np.testing.assert_allclose(a, r, rtol=TRACE_RTOL)
    np.testing.assert_array_equal(res.expsum_rank.numpy(), np.asarray(jres.expsum_rank))
    assert tuple(x.factors.shape) == tuple(jx.factors.shape) == (3, 20, 126)
    full, ref = tkt.cp_full(x), np.asarray(tk.cp_full(jx))
    assert float(np.abs(full - ref).max()) <= 1e-12 * float(np.abs(ref).max())


def test_multi_rhs_lanes_equal_rank1_solves(multi):
    """Each lane is the rank-1 solve of its term, to the bit; x concatenates
    their CP terms."""
    op, B = _rank2()
    _, (x, res) = multi
    for r in range(2):
        one = tkt.solve(op, torch.tensor(B[r]), tkt.SolverConfig(kmax=20, tol=1e-8))
        assert torch.equal(res.relative_residual[r], one.relative_residual)
        assert torch.equal(x.weights[63 * r:63 * (r + 1)], one.x.weights)
        assert torch.equal(x.factors[:, :, 63 * r:63 * (r + 1)], one.x.factors)
    assert res.config.step_impl == "xla"


def test_multi_rhs_dense_oracle(multi):
    op, B = _rank2()
    _, (x, _) = multi
    bfull = sum(np.kron(np.kron(B[r, 0], B[r, 1]), B[r, 2]) for r in range(2))
    resid = tkt.kron_matvec_dense(op, tkt.cp_full(x)) - bfull
    assert np.linalg.norm(resid) / np.linalg.norm(bfull) < 1e-7


def test_multi_rhs_aggregate_status(multi):
    """tests/test_solver.py's aggregate cases: all converged → CONVERGED; a
    lane at kmax → MAXITER; any breakdown → BREAKDOWN. Unpacks as (x, results)."""
    _, mr = multi
    assert mr.status == tkt.Status.CONVERGED and mr.converged
    x, res = mr
    assert tuple(res.status.shape) == (2,)
    op, B = _rank2()
    bad = tkt.solve_multi_rhs(op, torch.tensor(B), tkt.SolverConfig(kmax=4, tol=1e-12))
    assert bad.status == tkt.Status.MAXITER and not bad.converged
    broken = mr._replace(results=dataclasses.replace(res, status=torch.tensor([1, 2], dtype=torch.int32)))
    assert broken.status == tkt.Status.BREAKDOWN


def test_multi_rhs_rejects_bad_input():
    op, B = _rank2()
    with pytest.raises(ValueError, match=r"B must be \(R, d, n\)"):
        tkt.solve_multi_rhs(op, torch.tensor(B[0]))
    with pytest.raises(ValueError, match="orth='arnoldi'"):
        tkt.solve_multi_rhs(tkt.conv_diff(3, 20, device="cpu"), torch.tensor(B))


def _problem():
    b = tkt.random_rhs(3, 30, seed=17)
    return tkt.laplace(3, 30, device="cpu"), b / torch.linalg.vector_norm(b, dim=1, keepdim=True), tkt.SolverConfig(kmax=30, tol=1e-8)


def _assert_same_bits(a, b):
    assert (a.status, a.niterations) == (b.status, b.niterations)
    for f in FIELDS + ("orthogonality", "expsum_rank"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.x.weights, b.x.weights) and torch.equal(a.x.factors, b.x.factors)


def test_resumable_equals_solve(tmp_path):
    """Chunks of 7 with a checkpoint after each: solve()'s bits."""
    op, b, cfg = _problem()
    ref = tkt.solve(op, b, cfg)
    ckpt = str(tmp_path / "carry.pt")
    seg = tkt.solve_resumable(op, b, cfg, chunk=7, checkpoint_path=ckpt)
    _assert_same_bits(seg, ref)
    assert os.listdir(tmp_path) == ["carry.pt"]  # the atomic write leaves no temporary file


def test_resume_from_checkpoint_equals_solve(tmp_path):
    """tests/test_solver.py's crash case: 14 steps, a checkpoint, then a
    resumed solve in chunks of 9 continues bit for bit."""
    op, b, cfg = _problem()
    ref = tkt.solve(op, b, cfg)
    p, carry = _setup(op, b, cfg, None)
    carry = _segment(p, carry, 14)
    assert carry.k == 15
    ckpt = str(tmp_path / "carry.pt")
    save_carry(ckpt, carry)
    resumed = tkt.solve_resumable(op, b, cfg, checkpoint_path=ckpt, resume=True, chunk=9)
    _assert_same_bits(resumed, ref)


def test_resumable_matches_jax():
    """The trace of the JAX package's solve_resumable on the same inputs, to 1e-10."""
    jb = tk.random_rhs(3, 30, seed=17)
    jb = jb / jnp.linalg.norm(jb, axis=1, keepdims=True)
    ref = jax_solve_resumable(tk.laplace(3, 30), jb, tk.SolverConfig(kmax=30, tol=1e-8), chunk=7)
    res = tkt.solve_resumable(tkt.laplace(3, 30, device="cpu"), torch.tensor(np.asarray(jb)), tkt.SolverConfig(kmax=30, tol=1e-8),
                              chunk=7)
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), rtol=TRACE_RTOL)


def test_checkpoint_for_another_problem_raises(tmp_path):
    """The JAX package's message on a shape mismatch."""
    op, b, cfg = _problem()
    p, carry = _setup(op, b, cfg, None)
    ckpt = str(tmp_path / "carry.pt")
    save_carry(ckpt, _segment(p, carry, 3))
    _, other = _setup(op, b, dataclasses.replace(cfg, kmax=20), None)
    with pytest.raises(ValueError, match="checkpoint was written for a different problem size/config"):
        load_carry(ckpt, other)
    restored = load_carry(ckpt, carry)
    assert restored.k == 4 and type(restored) is type(carry)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        tkt.solve_resumable(op, b, cfg, chunk=0)
