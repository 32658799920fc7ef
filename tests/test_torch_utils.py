"""The port's utilities and guards on the CPU: utils/profiling.py,
utils/julia_serial.py against the JAX package's reader on a blob written in
the documented byte layout, the no-JAX import rule over every submodule, and
fast twins of the JAX package's slow property tests
(tests/test_solver.py:302, tests/test_reorth_auto.py:39, 54, 66, 87), with
their thresholds."""
import json
import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.models.gallery import bands_to_dense
from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_step, orthogonality_loss
from tensorkrylov_tpu_torch.utils import julia_serial, profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


# ---- utils/profiling.py ----

def test_device_trace_writes_a_trace(tmp_path):
    op = tkt.laplace(3, 20, device=CPU)
    with profiling.device_trace(str(tmp_path)):
        tkt.solve(op, tkt.random_rhs(3, 20, seed=1), tkt.SolverConfig(kmax=8, tol=1e-6))
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith(f"trace_{os.getpid()}_")
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in nm for nm in names)      # the solve's operators were recorded


def test_timed_block_fills_results(capsys):
    results = {}
    with profiling.timed_block("solve", results):
        sum(range(1000))
    assert set(results) == {"solve"} and results["solve"] >= 0.0
    with profiling.timed_block("printed"):
        pass
    assert capsys.readouterr().out.startswith("[printed] ")


def test_compiled_cost_raises_naming_item_10():
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md Queue 1, #10"):
        profiling.compiled_cost(lambda x: x, 1.0)


# ---- utils/julia_serial.py ----

def _array(elt: int, values: np.ndarray, long_len: bool) -> bytes:
    """One typed 1-D array in the documented encoding: 0x15 0x00 <eltype>
    <len> <data>, len a small-int tag (0xdf + len) or 0x31 + int32."""
    n = len(values)
    tag = b"\x31" + struct.pack("<i", n) if long_len else bytes([0xDF + n])
    dtype = "<i8" if elt == 0x08 else "<f8"
    return b"\x15\x00" + bytes([elt]) + tag + np.asarray(values, dtype=dtype).tobytes()


def _blob(rng) -> bytes:
    """An Experiment for dims (2, 3) at n=40 (int32 length tags) with traces
    of 5 and 7 entries (small-int tags), behind a header and between struct
    bytes that hold no array."""
    dims, n = [2, 3], 40
    out = [b"JLS\x00header", _array(0x08, np.asarray(dims), False)]
    for d in dims:
        for _ in range(d):
            out += [b"\x01\x02", _array(0x0E, rng.standard_normal(n), True)]
    for k in (5, 7):
        out.append(_array(0x08, np.arange(1, k + 1), False))
        out += [_array(0x0E, np.abs(rng.standard_normal(k)), False) for _ in range(3)]
    return b"".join(out)


def test_julia_serial_matches_the_jax_reader(tmp_path):
    from tensorkrylov_tpu.utils import julia_serial as jax_julia

    path = tmp_path / "experiment.jls"
    path.write_bytes(_blob(np.random.default_rng(3)))
    ours, theirs = julia_serial.scan_typed_arrays(str(path)), jax_julia.scan_typed_arrays(str(path))
    assert [(k, off) for k, off, _ in ours] == [(k, off) for k, off, _ in theirs]
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for (_, _, a), (_, _, b) in zip(ours, theirs))
    assert [k for k, _, _ in ours] == ["i8"] + ["f8"] * 5 + (["i8"] + ["f8"] * 3) * 2

    e, j = julia_serial.load_reference_experiment(str(path)), jax_julia.load_reference_experiment(str(path))
    assert isinstance(e, julia_serial.ReferenceExperiment)
    assert (e.dims, e.n) == (j.dims, j.n) == ([2, 3], 40)
    assert all(np.array_equal(a, b) for a, b in zip(e.rhs, j.rhs))
    assert [r.shape for r in e.rhs] == [(2, 40), (3, 40)]
    for te, tj in zip(e.traces, j.traces):
        assert te.keys() == tj.keys()
        assert all(np.array_equal(te[key], tj[key]) for key in te)
    assert [len(t["iterations"]) for t in e.traces] == [5, 7]


def test_julia_serial_rejects_a_bad_layout(tmp_path):
    path = tmp_path / "bad.jls"
    path.write_bytes(_array(0x0E, np.ones(3), False))
    with pytest.raises(ValueError, match="leading dims Int64 array"):
        julia_serial.load_reference_experiment(str(path))


# ---- the port imports no JAX ----

def test_no_jax_in_any_submodule():
    """Import the port and every one of its submodules in a fresh process:
    neither jax nor the JAX package may be loaded."""
    code = ("import importlib, pkgutil, sys, tensorkrylov_tpu_torch as p;"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')];"
            "[importlib.import_module(nm) for nm in names];"
            "bad = [m for m in sys.modules if m in ('jax', 'tensorkrylov_tpu') or m.startswith(('jax.', "
            "'tensorkrylov_tpu.'))];"
            "print(names); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    names = proc.stdout.splitlines()[0]
    for name in ("parallel.multihost", "parallel._smoke", "utils.profiling", "utils.julia_serial", "solver",
                 "ops.ring_spmv", "experiments.northstar", "coeffs.preprocess", "native"):
        assert f"'tensorkrylov_tpu_torch.{name}'" in names


# ---- fast twins of the JAX package's slow property tests ----

def _unit_rhs(d, n, seed):
    b = tkt.random_rhs(d, n, seed=seed)
    return b / torch.linalg.vector_norm(b, dim=1, keepdim=True)


def test_monotone_Anorm_error():
    """The Galerkin property: the A-norm error does not grow with the
    subspace (tests/test_solver.py:302)."""
    d, n = 2, 12
    op = tkt.laplace(d, n, device=CPU)
    b = _unit_rhs(d, n, 25)
    A1 = bands_to_dense(op)
    Afull = np.kron(A1[0], np.eye(n)) + np.kron(np.eye(n), A1[1])
    xstar = np.linalg.solve(Afull, np.kron(b[0].numpy(), b[1].numpy()))
    errs = []
    for kmax in (2, 4, 6, 8, 10):
        res = tkt.solve(op, b, tkt.SolverConfig(kmax=kmax, tol=1e-14, tmax=201))
        e = tkt.cp_full(res.x) - xstar
        errs.append(float(np.sqrt(e @ (Afull @ e))))
    for a, bb in zip(errs, errs[1:]):
        assert bb <= a * (1 + 1e-6), errs


def _hard_op_rhs(seed=7, n=48):
    """tests/test_reorth_auto.py's gapped spectrum: plain Lanczos loses
    orthogonality fast."""
    ev = np.concatenate([np.geomspace(1.0, 1e6, n - 4), [2e6, 3e6, 4e6, 5e6]])
    op = tkt.eigval_matrix(ev, d=2, device=CPU)
    b = np.random.default_rng(seed).normal(size=(2, n))
    return op, torch.from_numpy(b / np.linalg.norm(b, axis=1, keepdims=True))


def _run_steps(op, b, k_steps, reorth):
    state, _ = init_state(op, b, k_steps, torch.float64)
    losses = []
    for k in range(1, k_steps + 1):
        state, loss = lanczos_step(op, state, b, k, reorth=reorth, proj_dtype=torch.float64)
        losses.append(float(loss))
    return state, losses


def test_auto_reorth_restores_orthogonality():
    """tests/test_reorth_auto.py:39: loss > 1e-4 plain, < 1e-6 auto."""
    op, b = _hard_op_rhs()
    k = 40
    st_plain, _ = _run_steps(op, b, k, reorth=False)
    st_auto, _ = _run_steps(op, b, k, reorth="auto")
    loss_plain = float(orthogonality_loss(st_plain.V, k + 1))
    loss_auto = float(orthogonality_loss(st_auto.V, k + 1))
    assert loss_plain > 1e-4, loss_plain
    assert loss_auto < 1e-6, loss_auto


def test_auto_matches_always_solution_quality():
    """tests/test_reorth_auto.py:54, on its rng's draw."""
    op = tkt.laplace(3, 24, device=CPU)
    b = torch.from_numpy(np.random.default_rng(12345).normal(size=(3, 24)))
    res_always = tkt.solve(op, b, tkt.SolverConfig(kmax=24, tol=1e-9, orth="lanczos_reorth"))
    res_auto = tkt.solve(op, b, tkt.SolverConfig(kmax=24, tol=1e-9, orth="lanczos_reorth_auto"))
    assert res_auto.status == tkt.Status.CONVERGED
    ra = tkt.kron_residual_dense(op, res_auto.x, b.numpy())
    rb = tkt.kron_residual_dense(op, res_always.x, b.numpy())
    assert ra < 1e-9 and rb < 1e-9


def test_probe_telemetry_nonzero_plain():
    """tests/test_reorth_auto.py:66: plain Lanczos reports a measured drift."""
    op, b = _hard_op_rhs()
    _, losses = _run_steps(op, b, 40, reorth=False)
    arr = np.asarray(losses[5:])
    assert np.all(arr > 0.0)
    assert np.max(arr) > 1e-8


def test_twopass_and_block_telemetry_nonzero():
    """tests/test_reorth_auto.py:87: the two-pass and block solves record a
    nonzero orthogonality probe at every step."""
    rng = np.random.default_rng(12345)
    op = tkt.laplace(2, 24, device=CPU)
    b = torch.from_numpy(rng.normal(size=(2, 24)))
    r2 = tkt.solve_two_pass(op, b, tkt.SolverConfig(kmax=20, tol=1e-10, orth="lanczos"))
    assert np.all(r2.orthogonality[1:r2.niterations + 1].numpy() > 0.0)
    B = torch.from_numpy(rng.normal(size=(2, 2, 24)))
    rb = tkt.solve_block(op, B, tkt.SolverConfig(kmax=8, tol=1e-10))
    assert np.all(rb.orthogonality[1:rb.niterations + 1].numpy() > 0.0)


def test_hard_spectrum_matches_the_jax_steps():
    """The twins' operator and steps are the JAX test's: the first 10 plain
    steps' α and β agree with the JAX package's to 1e-10 relative."""
    import tensorkrylov_tpu as tk
    from tensorkrylov_tpu.ops import orth as jorth

    op, b = _hard_op_rhs()
    st, _ = _run_steps(op, b, 10, reorth=False)
    jop = tk.eigval_matrix(np.concatenate([np.geomspace(1.0, 1e6, 44), [2e6, 3e6, 4e6, 5e6]]), d=2)
    jb = jnp.asarray(b.numpy())
    js, _ = jorth.init_state(jop, jb, 10, jnp.float64)
    for k in range(1, 11):
        js, _ = jorth.lanczos_step(jop, js, jb, k, reorth=False, proj_dtype=jnp.float64)
    np.testing.assert_allclose(st.H.numpy()[:, :11, :11], np.asarray(js.H)[:, :11, :11], rtol=1e-10, atol=1e-6)
