"""The port's two-pass (basis-free) solve on the CPU: against the JAX
package's on the same inputs, against the port's basis-storing solve with
orth='lanczos' (bit for bit on the fused route), and the dense oracle
(tests/test_twopass.py's cases). The fused route runs the fused core's plain
version, fused_lanczos_core_reference, on CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.ops import banded, fused_lanczos

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)

# Plain Lanczos without reorthogonalization amplifies each package's own sum
# order about 2.6× per step, so the traces of the two packages part by ~1e-10
# relative after 30 steps and, on the distinct spectra, by ~1e-13 of ‖b‖ (1e-5
# relative) at the last estimates near 2e-8; tests/test_twopass.py holds
# two-pass and solve to rtol 1e-10 at the last step and the factors to atol 1e-10
TRACE_RTOL, TRACE_ATOL, X_ATOL = 1e-8, 1e-12, 1e-10


def _normalized_rhs(d, n, seed, identical=True):
    b = tk.random_rhs(d, n, seed=seed, identical=identical)
    return np.asarray(b / jnp.linalg.norm(b, axis=1, keepdims=True))


# name: (operator factory (JAX, port), d, n, seed, identical rows, config fields)
CASES = {
    "laplace": (lambda m, **kw: m.laplace(3, 30, **kw), 30, 7, True, dict(kmax=30, tol=1e-8, orth="lanczos")),
    "check_every": (lambda m, **kw: m.laplace(3, 30, **kw), 30, 5, True,
                    dict(kmax=30, tol=1e-8, orth="lanczos", check_every=4)),
    "distinct": (lambda m, **kw: m.eigval_matrix(np.stack([np.linspace(1.0, 40.0, 24), np.linspace(2.0, 55.0, 24)]),
                                                 **kw), 24, 10, False, dict(kmax=24, tol=1e-8, orth="lanczos")),
}


def _case(name):
    make, n, seed, identical, fields = CASES[name]
    b = _normalized_rhs(3 if n == 30 else 2, n, seed, identical)
    return make(tk), make(tkt, device="cpu"), b, fields


@pytest.mark.parametrize("name", ["laplace", "check_every", pytest.param("distinct", marks=pytest.mark.slow)])
def test_two_pass_matches_jax(name):
    jop, op, b, fields = _case(name)
    ref = tk.solve_two_pass(jop, b, tk.SolverConfig(**fields))
    res = tkt.solve_two_pass(op, torch.tensor(b), tkt.SolverConfig(**fields))
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations)) == (tkt.Status.CONVERGED,
                                                                                        res.niterations)
    idx = np.flatnonzero(np.isfinite(np.asarray(ref.relative_residual)))
    for f in ("relative_residual", "lambda_min", "lambda_max"):
        np.testing.assert_allclose(getattr(res, f).numpy()[idx], np.asarray(getattr(ref, f))[idx], rtol=TRACE_RTOL,
                                   atol=TRACE_ATOL if f == "relative_residual" else 0.0, err_msg=f)
    np.testing.assert_allclose(res.x.factors.numpy(), np.asarray(ref.x.factors), rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(res.x.weights.numpy(), np.asarray(ref.x.weights), rtol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_pass_matches_solve_and_dense_oracle(name):
    """tests/test_twopass.py's bounds against the basis-storing solve: the same
    steps, the last estimate to rtol 1e-10, the lifted factors to atol 1e-10;
    and the dense-oracle residual below tol."""
    _, op, b, fields = _case(name)
    cfg = tkt.SolverConfig(**fields)
    res, std = tkt.solve_two_pass(op, torch.tensor(b), cfg), tkt.solve(op, torch.tensor(b), cfg)
    k = res.niterations
    assert res.status == tkt.Status.CONVERGED and k == std.niterations
    np.testing.assert_allclose(float(res.relative_residual[k]), float(std.relative_residual[k]), rtol=1e-10)
    np.testing.assert_allclose(res.x.factors.numpy(), std.x.factors.numpy(), rtol=0, atol=X_ATOL)
    assert tkt.kron_residual_dense(op, res.x, b) < 1e-8


@pytest.mark.parametrize("name", ["laplace", "check_every"])
def test_fused_two_pass_equals_fused_solve(name, monkeypatch):
    """step_impl='fused': pass 1 is the fused core (its plain version here),
    one call per step, and records solve's fused α and β bit for bit: the same
    traces, and x from the regenerated basis within atol 1e-10. Pass 2 is one
    SpMV per step."""
    _, op, b, fields = _case(name)
    cfg = tkt.SolverConfig(**fields, step_impl="fused")
    calls = {"fused": 0, "spmv": 0}
    core, spmv_ref = fused_lanczos.fused_lanczos_core_reference, banded.spmv_reference

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(fused_lanczos, "fused_lanczos_core_reference", count("fused", core))
    monkeypatch.setattr(banded, "spmv_reference", count("spmv", spmv_ref))
    res = tkt.solve_two_pass(op, torch.tensor(b), cfg)
    k = res.niterations
    assert res.config.step_impl == "fused" and calls == {"fused": k, "spmv": k}
    std = tkt.solve(op, torch.tensor(b), cfg)
    assert (res.status, k) == (std.status, std.niterations)
    for f in ("relative_residual", "projected_residual", "lambda_min", "lambda_max", "expsum_rank"):
        assert torch.equal(getattr(res, f), getattr(std, f)), f
    assert torch.equal(res.x.weights, std.x.weights)
    np.testing.assert_allclose(res.x.factors.numpy(), std.x.factors.numpy(), rtol=0, atol=X_ATOL)


def test_two_pass_unfused_spmv_counts(monkeypatch):
    """The unfused route: one SpMV per step in each pass."""
    _, op, b, fields = _case("laplace")
    n_calls = []
    real = banded.spmv_reference
    monkeypatch.setattr(banded, "spmv_reference", lambda o, v: n_calls.append(1) or real(o, v))
    res = tkt.solve_two_pass(op, torch.tensor(b), tkt.SolverConfig(**fields))
    assert res.config.step_impl == "xla" and len(n_calls) == 2 * res.niterations


def test_two_pass_rejects_bad_config():
    op = tkt.laplace(2, 16, device="cpu")
    b = torch.tensor(_normalized_rhs(2, 16, 1))
    with pytest.raises(ValueError, match="plain Lanczos"):
        tkt.solve_two_pass(op, b, tkt.SolverConfig(orth="lanczos_reorth"))
    with pytest.raises(ValueError, match="symmetric"):
        tkt.solve_two_pass(tkt.conv_diff(2, 16, device="cpu"), b, tkt.SolverConfig(orth="lanczos"))
    with pytest.raises(ValueError, match=r"b must be \(d, n\)"):
        tkt.solve_two_pass(op, b[:1], tkt.SolverConfig(orth="lanczos"))
