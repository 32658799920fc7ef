"""The port's mode-sharded solve on 8 CPU shard slots against the JAX
package: solve_sharded with comm='ring' and comm='gspmd' against the JAX
package's single-device solve and its own solve_sharded on 8 virtual devices,
the factor-parallel mesh, Arnoldi, the sharded steps against JAX's steps on a
state carried across, and the error paths. Inputs are made with numpy and
handed to both packages."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu.ops import orth as jorth
from tensorkrylov_tpu.parallel import make_mesh as jax_make_mesh
from tensorkrylov_tpu.parallel import solve_sharded as jax_solve_sharded
from tensorkrylov_tpu_torch.interop import (config_from_fields, operator_from_numpy, result_to_numpy,
                                            sharded_operator_from_numpy, sharded_state_from_numpy,
                                            sharded_state_to_numpy)
from tensorkrylov_tpu_torch.ops import _build
from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_step
from tensorkrylov_tpu_torch.parallel import krylov, make_mesh, shard_operator, shard_rhs, solve_sharded
from tensorkrylov_tpu_torch.utils.cp import kron_residual_dense

# many small eigh and einsum calls per solve: one intra-op thread per test
# worker keeps parallel workers from oversubscribing the cores
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def _port_config(jcfg):
    return config_from_fields({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _problem(gallery, d, n, seed, normalize=True):
    jop = getattr(tk, gallery)(d, n)
    jb = tk.random_rhs(d, n, seed=seed)
    if normalize:
        jb = jb / jnp.linalg.norm(jb, axis=1, keepdims=True)
    return jop, jb, operator_from_numpy(np.asarray(jop.bands), jop.offsets, jop.symmetric), torch.tensor(np.asarray(jb))


def _assert_traces_match(res, ref, rtol=1e-8, atol=1e-12):
    """Same status and niterations; relative-residual traces within the
    tolerances of tests/test_sharding.py:42-46."""
    assert res.status == int(ref.status)
    assert res.niterations == int(ref.niterations)
    k = res.niterations
    np.testing.assert_allclose(result_to_numpy(res)["relative_residual"][:k + 1],
                               np.asarray(ref.relative_residual)[:k + 1], rtol=rtol, atol=atol)


SOLVES = {
    "laplace_d3": ("laplace", 3, 32, 5, dict(kmax=32, tol=1e-8), 1, 1e-8),
    "laplace_d4": ("laplace", 4, 32, 5, dict(kmax=32, tol=1e-8), 1, 1e-8),
    "factor_parallel_2": ("laplace", 2, 32, 6, dict(kmax=32, tol=1e-7), 2, 1e-7),
}


@pytest.mark.parametrize("comm", ["ring", "gspmd"])
@pytest.mark.parametrize("case", sorted(SOLVES))
def test_solve_sharded_matches_jax_solve(case, comm):
    """The sharded solve against the JAX package's single-device solve on the
    same numpy inputs: status, niterations, traces to rtol 1e-8, atol 1e-12,
    and the dense oracle."""
    gallery, d, n, seed, fields, fp, dense_tol = SOLVES[case]
    jop, jb, op, b = _problem(gallery, d, n, seed)
    jcfg = tk.SolverConfig(**fields)
    ref = tk.solve(jop, jb, jcfg)
    before = dict(_build.launches)
    res = solve_sharded(op, b, _port_config(jcfg), make_mesh(devices=CPU8, factor_parallel=fp), comm)
    assert dict(_build.launches) == before  # CPU shards take the plain versions
    _assert_traces_match(res, ref)
    assert res.config.step_impl == "xla" and tuple(res.x.factors.shape) == (d, n, jcfg.tmax)
    assert kron_residual_dense(op, res.x, b) < dense_tol


def test_solve_sharded_arnoldi_matches_jax_solve():
    """orth='arnoldi' on conv_diff(3, 32), the rank-601 sinc rule, a check
    every 4 steps, through the ring route: the same checks against the JAX
    package's solve (both with nonsym_solve_impl='eig')."""
    jop, jb, op, b = _problem("conv_diff", 3, 32, 7, normalize=False)
    jcfg = tk.SolverConfig(kmax=32, tol=1e-8, orth="arnoldi", tmax=601, check_every=4)
    jcfg = dataclasses.replace(jcfg, nonsym_solve_impl="eig")
    ref = tk.solve(jop, jb, jcfg)
    res = solve_sharded(op, b, _port_config(jcfg), make_mesh(devices=CPU8), "ring")
    _assert_traces_match(res, ref)
    assert res.status == tkt.Status.CONVERGED and kron_residual_dense(op, res.x, b) < 1e-8


def test_solve_sharded_matches_jax_solve_sharded():
    """Against the JAX package's own solve_sharded(comm='ring') on 8 virtual
    devices, laplace(3, 32), kmax=16."""
    jop, jb, op, b = _problem("laplace", 3, 32, 5)
    jcfg = tk.SolverConfig(kmax=16, tol=1e-8)
    ref = jax_solve_sharded(jop, jb, jcfg, jax_make_mesh(8), comm="ring")
    res = solve_sharded(op, b, _port_config(jcfg), make_mesh(devices=CPU8), "ring")
    _assert_traces_match(res, ref)
    np.testing.assert_allclose(result_to_numpy(res)["lambda_min"], np.asarray(ref.lambda_min), rtol=1e-10)


@pytest.mark.parametrize("orth", ["lanczos", "lanczos_reorth", "lanczos_reorth_auto", "arnoldi"])
@pytest.mark.parametrize("comm", ["ring", "gspmd"])
def test_sharded_steps_match_jax_steps(comm, orth):
    """A JAX state after 6 steps, carried into the port's sharded state
    (interop), advanced 3 steps by both packages: V, H and b̃ agree to 1e-12."""
    jop, jb, op, b = _problem("conv_diff" if orth == "arnoldi" else "laplace", 3, 40, 9, normalize=False)
    if orth == "arnoldi":
        jstep = jax.jit(functools.partial(jorth.arnoldi_step, proj_dtype=jnp.float64))
    else:
        reorth = {"lanczos": False, "lanczos_reorth": True, "lanczos_reorth_auto": "auto"}[orth]
        jstep = jax.jit(functools.partial(jorth.lanczos_step, reorth=reorth, proj_dtype=jnp.float64))
    jst, _ = jorth.init_state(jop, jb, 12, jnp.float64)
    for k in range(1, 7):
        jst, _ = jstep(jop, jst, jb, k)
    mesh = make_mesh(devices=CPU8, factor_parallel=1)
    sop = sharded_operator_from_numpy(np.asarray(jop.bands), jop.offsets, mesh, jop.symmetric, comm)
    st = sharded_state_from_numpy(*(np.asarray(a) for a in jst), sop)
    step = krylov.step_fn(tkt.SolverConfig(orth=orth))
    bs = shard_rhs(b, mesh)
    for k in range(7, 10):
        jst, _ = jstep(jop, jst, jb, k)
        st, _ = step(sop, st, bs, k)
    got = sharded_state_to_numpy(st, sop)
    for name, g, r in zip(("V", "H", "btil"), got[:3], jst[:3]):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12 * np.abs(r).max(), err_msg=name)


def test_lucky_restart_gives_the_unsharded_vector():
    """kmax = n exhausts the Krylov space: the last step restarts. Its
    direction uses each shard's global column, so the sharded basis equals
    the unsharded one to rounding there too."""
    op = tkt.eigval_matrix(np.arange(1.0, 9.0), d=2, device="cpu")   # Krylov space of b: dimension 8
    b = torch.ones((2, 8), dtype=torch.float64)
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    sop = shard_operator(op, mesh, "ring")
    bs = shard_rhs(b, mesh)
    st, _ = init_state(op, b, 9, torch.float64)
    sst, _ = krylov.init_state(sop, bs, 9, torch.float64)
    for k in range(1, 10):
        st, _ = lanczos_step(op, st, b, k, reorth=True, proj_dtype=torch.float64)
        sst, _ = krylov.lanczos_step(sop, sst, bs, k, reorth=True, proj_dtype=torch.float64)
    assert float(st.H[0, 8, 7]) == 0.0 == float(sst.H[0, 8, 7])   # β = 0 at k = 8: the restart
    V = sharded_state_to_numpy(sst, sop).V
    np.testing.assert_allclose(V, st.V.numpy(), rtol=0, atol=1e-12)


def test_solve_sharded_rejects_bad_input():
    op, b = tkt.laplace(2, 16, device="cpu"), tkt.random_rhs(2, 16)
    mesh = make_mesh(devices=CPU8)
    with pytest.raises(ValueError, match="comm must be 'gspmd' or 'ring'"):
        solve_sharded(op, b, tkt.SolverConfig(kmax=4), mesh, comm="ppermute")
    with pytest.raises(ValueError, match="multiple of the 8 mode shards"):
        solve_sharded(tkt.laplace(2, 20, device="cpu"), tkt.random_rhs(2, 20), tkt.SolverConfig(kmax=4), mesh)
    with pytest.raises(ValueError, match="narrower than the halo width 2"):
        solve_sharded(tkt.conv_diff(2, 8, device="cpu"), tkt.random_rhs(2, 8),
                      tkt.SolverConfig(kmax=4, orth="arnoldi"), mesh)
    with pytest.raises(ValueError, match="orth='arnoldi'"):
        solve_sharded(tkt.conv_diff(2, 16, device="cpu"), tkt.random_rhs(2, 16), tkt.SolverConfig(kmax=4), mesh)


def test_step_impl_is_forced_and_recorded():
    """Any step_impl resolves to 'xla', as sharding.py:95-98; the factor axis
    is left unused when it does not divide d (d=3 on a 2 × 4 mesh)."""
    op, b = tkt.laplace(3, 16, device="cpu"), tkt.random_rhs(3, 16, seed=2)
    mesh = make_mesh(devices=CPU8, factor_parallel=2)
    res = solve_sharded(op, b, tkt.SolverConfig(kmax=16, tol=1e-8, orth="lanczos_reorth_auto", step_impl="fused"),
                        mesh, "gspmd")
    ref = tkt.solve(op, b, tkt.SolverConfig(kmax=16, tol=1e-8, orth="lanczos_reorth_auto"))
    assert res.config.step_impl == "xla"
    _assert_traces_match(res, ref)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
