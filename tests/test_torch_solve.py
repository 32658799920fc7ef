"""The port's solve() end to end on the CPU: the committed golden trace, the
JAX package's solve on the same inputs, the dense oracle, config resolution
and the error paths."""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.interop import config_from_fields, operator_from_numpy, result_to_numpy
from tensorkrylov_tpu_torch.ops import _build, fused_lanczos

# The solves here run many small eigh and einsum calls: one intra-op thread
# per process keeps parallel test workers from oversubscribing the cores,
# where spinning thread pools slow such calls a hundredfold.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden_laplace_d4_n100.json")


def _port_config(jcfg):
    return config_from_fields({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def test_golden_trace():
    """Same checks as tests/test_golden.py: status, niterations, trace to rtol 1e-6."""
    with open(GOLDEN) as f:
        g = json.load(f)
    op = tkt.laplace(g["d"], g["n"], device="cpu")
    b = tkt.random_rhs(g["d"], g["n"], seed=g["seed"])
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    res = tkt.solve(op, b, tkt.SolverConfig(kmax=g["n"], tol=g["tol"], orth=g["orth"]))
    assert res.status == g["status"]
    assert res.niterations == g["niterations"]
    rr = res.relative_residual[1:g["niterations"] + 1].numpy()
    np.testing.assert_allclose(rr, np.asarray(g["relative_residual"]), rtol=1e-6)


def _problem(kind):
    if kind == "rand_spd":
        jop, jb = tk.rand_spd(2, 10, seed=3), tk.random_rhs(2, 10, seed=4, identical=False)
    else:
        jop, jb = tk.laplace(3, 30), tk.random_rhs(3, 30, seed=7)
        jb = jb / jnp.linalg.norm(jb, axis=1, keepdims=True)
    return jop, jb, operator_from_numpy(np.asarray(jop.bands), jop.offsets), torch.tensor(np.asarray(jb))


CASES = {
    "lanczos": ("laplace", dict(orth="lanczos")),
    "lanczos_reorth": ("laplace", dict(orth="lanczos_reorth")),
    "lanczos_reorth_auto": ("laplace", dict(orth="lanczos_reorth_auto")),
    "fused": ("laplace", dict(orth="lanczos_reorth_auto", step_impl="fused")),
    "check_every_4": ("laplace", dict(check_every=4)),
    "identical_factors": ("laplace", dict(identical_factors=True)),
    "rand_spd_tmax101": ("rand_spd", dict(tmax=101)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_matches_jax(case):
    """Same status and niterations as the JAX package's solve; relative
    residual trace to rtol 1e-6; spectral estimates to 1e-10."""
    kind, fields = CASES[case]
    jop, jb, op, b = _problem(kind)
    jcfg = tk.SolverConfig(kmax=30, tol=1e-8, **fields)
    ref = tk.solve(jop, jb, jcfg)
    res = tkt.solve(op, b, _port_config(jcfg))
    assert res.status == int(ref.status)
    assert res.niterations == int(ref.niterations)
    k = res.niterations
    checked = np.isfinite(np.asarray(ref.relative_residual)[1:k + 1])
    got = result_to_numpy(res)
    np.testing.assert_allclose(got["relative_residual"][1:k + 1][checked],
                               np.asarray(ref.relative_residual)[1:k + 1][checked], rtol=1e-6)
    for f in ("lambda_min", "lambda_max"):
        np.testing.assert_allclose(got[f][1:k + 1], np.asarray(getattr(ref, f))[1:k + 1], rtol=1e-10)
    np.testing.assert_array_equal(got["expsum_rank"], np.asarray(ref.expsum_rank))
    assert res.config.step_impl == ("fused" if case == "fused" else "xla")


def test_fused_trace_depends_on_sum_order(monkeypatch):
    """Why the fused core's plain version sums in the kernel's fixed order.
    Without reorthogonalization (the auto probe never fires here) the
    recurrence amplifies a change in the rounding of its α, β², ⟨u, b⟩ sums
    about 2.6× per step: summing in torch.sum's order instead moves the
    relative-residual trace of this d=10, n=4096 solve by rounding (1e-16 to
    1e-11) over the first 10 steps and by more than 1e-6 at the last of its
    29, while the spectra still agree."""
    n = 4096
    lmin, lmax = (4.0 * (n + 1) ** 2 * np.sin(j * np.pi / (2 * (n + 1))) ** 2 for j in (1, n))
    op = tkt.reaction_diffusion(10, n, (lmax - 1e2 * lmin) / (1e2 - 1.0), device="cpu")  # factor κ = 1e2
    b = tkt.random_rhs(10, n, seed=1234)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    cfg = tkt.SolverConfig(kmax=40, tol=1e-8, orth="lanczos_reorth_auto", step_impl="fused")
    fixed = tkt.solve(op, b, cfg)
    monkeypatch.setattr(fused_lanczos, "fixed_order_sum", lambda x: torch.sum(x, -1))
    other = tkt.solve(op, b, cfg)
    assert (fixed.status, fixed.niterations) == (other.status, other.niterations) == (tkt.Status.CONVERGED, 29)
    k = fixed.niterations
    gap = ((fixed.relative_residual - other.relative_residual).abs() / other.relative_residual)[1:k + 1]
    assert float(gap[:10].max()) < 1e-10
    assert 1e-6 < float(gap[-1]) < 1e-3
    for f in ("lambda_min", "lambda_max"):
        torch.testing.assert_close(getattr(fixed, f)[1:k + 1], getattr(other, f)[1:k + 1], rtol=1e-12, atol=0)


def test_dense_oracle_residual():
    op = tkt.laplace(3, 30, device="cpu")
    b = tkt.random_rhs(3, 30, seed=7)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    launches = dict(_build.launches)
    res = tkt.solve(op, b, tkt.SolverConfig(kmax=30, tol=1e-8))
    assert res.status == tkt.Status.CONVERGED
    true_r = tkt.kron_residual_dense(op, res.x, b)
    assert true_r <= 1e-8
    assert float(res.relative_residual[res.niterations]) >= 0.5 * true_r  # the estimate is not optimistic
    assert dict(_build.launches) == launches  # CPU tensors take the plain versions


def test_wrong_shape_b_raises():
    with pytest.raises(ValueError, match=r"b must be \(d, n\)"):
        tkt.solve(tkt.laplace(3, 10, device="cpu"), torch.ones((3, 11), dtype=torch.float64))


@pytest.mark.parametrize("orth,error", [("lanczos_reorth", ValueError), ("lanczos", ValueError)])
def test_nonsymmetric_operator_raises(orth, error):
    """A nonsymmetric operator needs orth='arnoldi', in both entry points."""
    op = dataclasses.replace(tkt.laplace(2, 10, device="cpu"), symmetric=False)
    for entry in (tkt.solve, tkt.solve_host_projected):
        with pytest.raises(error, match="orth='arnoldi'"):
            entry(op, torch.ones((2, 10), dtype=torch.float64), tkt.SolverConfig(orth=orth))


@pytest.mark.parametrize("fields,error", [
    (dict(orth="lanczos_reorth_auto", symmetric=False), ValueError),  # nonsymmetric without Arnoldi
    (dict(eigh_impl="host"), ValueError),
    (dict(identical_factors=True), ValueError),  # distinct RHS rows
    (dict(orth="bogus"), ValueError),
])
def test_unsupported_options_raise(fields, error):
    fields = dict(fields)
    op = dataclasses.replace(tkt.laplace(2, 10, device="cpu"), symmetric=fields.pop("symmetric", True))
    b = torch.tensor(np.random.default_rng(0).random((2, 10)))
    with pytest.raises(error):
        tkt.solve(op, b, tkt.SolverConfig(**fields))


@pytest.mark.parametrize("fields,resolved", [
    (dict(), dict(step_impl="xla", eigh_impl="dense")),
    (dict(step_impl="resident"), dict(step_impl="xla")),  # resident segments: solve_host_projected only
    (dict(step_impl="resident", orth="lanczos", basis_dtype=torch.float32), dict(step_impl="xla")),
    (dict(step_impl="fused", orth="lanczos"), dict(step_impl="fused")),
    (dict(step_impl="fused"), dict(step_impl="xla")),  # always-on sweep: unfused step
    (dict(step_impl="fused", orth="lanczos", basis_dtype=torch.float32), dict(step_impl="fused")),
    (dict(kmax=50), dict(kmax=12)),
])
def test_resolved_config_is_recorded(fields, resolved):
    op = tkt.laplace(2, 12, device="cpu")
    res = tkt.solve(op, tkt.random_rhs(2, 12, seed=1), tkt.SolverConfig(tol=1e-8, **fields))
    for f, v in resolved.items():
        assert getattr(res.config, f) == v


def test_debug_prints_each_check(capsys):
    res = tkt.solve(tkt.laplace(2, 12, device="cpu"), tkt.random_rhs(2, 12, seed=1),
                    tkt.SolverConfig(tol=1e-8, check_every=2, debug=True))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("k=")]
    assert len(lines) == (res.niterations + 1) // 2 and "rel_res=" in lines[-1]


def test_config_from_fields_maps_dtypes():
    jcfg = tk.SolverConfig(basis_dtype=jnp.float32, tol=1e-7)
    cfg = _port_config(jcfg)
    assert cfg.basis_dtype == torch.float32 and cfg.proj_dtype == torch.float64 and cfg.tol == 1e-7
    assert config_from_fields({"basis_dtype": "float32"}).basis_dtype == torch.float32


def test_import_leaves_jax_out():
    code = ("import sys, tensorkrylov_tpu_torch, tensorkrylov_tpu_torch.interop, tensorkrylov_tpu_torch.ops.orth,"
            " tensorkrylov_tpu_torch.ops.resident_lanczos, tensorkrylov_tpu_torch.ops.expsum,"
            " tensorkrylov_tpu_torch.models.gallery, tensorkrylov_tpu_torch.solver,"
            " tensorkrylov_tpu_torch.bench, tensorkrylov_tpu_torch.native, tensorkrylov_tpu_torch.__main__,"
            " tensorkrylov_tpu_torch.convergence, tensorkrylov_tpu_torch.system,"
            " tensorkrylov_tpu_torch.experiments.reproduction, tensorkrylov_tpu_torch.ops.resident_spmv,"
            " tensorkrylov_tpu_torch.utils.checkpoint, tensorkrylov_tpu_torch.ops.ring_spmv,"
            " tensorkrylov_tpu_torch.parallel, tensorkrylov_tpu_torch.parallel.sharding,"
            " tensorkrylov_tpu_torch.parallel.halo, tensorkrylov_tpu_torch.parallel.krylov,"
            " tensorkrylov_tpu_torch.block, tensorkrylov_tpu_torch.twopass, tensorkrylov_tpu_torch.refine,"
            " tensorkrylov_tpu_torch.utils.cp, tensorkrylov_tpu_torch.experiments.eigenvalue_distribution,"
            " tensorkrylov_tpu_torch.experiments.parameterized_systems, tensorkrylov_tpu_torch.experiments.plotting,"
            " tensorkrylov_tpu_torch.deflate, tensorkrylov_tpu_torch.deflate_light,"
            " tensorkrylov_tpu_torch.experiments.northstar,"
            " tensorkrylov_tpu_torch.ops.expansion, tensorkrylov_tpu_torch.df64_core,"
            " tensorkrylov_tpu_torch.block_recorded, tensorkrylov_tpu_torch.experiments.config4_block,"
            " tensorkrylov_tpu_torch.experiments.nonsym_scale, tensorkrylov_tpu_torch.experiments.dryrun_multichip;"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tensorkrylov_tpu.'))"
            " or m == 'tensorkrylov_tpu'];"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
