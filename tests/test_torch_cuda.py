"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and a solve that must go through them. These tests skip where no
CUDA device is present. This file imports no JAX, so on a machine with the
card and without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch import deflate, solver
from tensorkrylov_tpu_torch.coeffs.tables import load_tables, select_bh
from tensorkrylov_tpu_torch.ops import _build, _cluster, expsum
from tensorkrylov_tpu_torch.ops.banded import spmv, spmv_reference
from tensorkrylov_tpu_torch.ops import fused_lanczos
from tensorkrylov_tpu_torch.ops.fused_lanczos import fused_lanczos_core, fused_lanczos_core_reference
from tensorkrylov_tpu_torch.ops import resident_lanczos
from tensorkrylov_tpu_torch.ops.resident_lanczos import (
    lanczos_resident_steps, lanczos_resident_steps_reference, resident_lanczos_plan)
from tensorkrylov_tpu_torch.ops.resident_spmv import resident_spmv_plan, spmv_multi_apply, spmv_multi_apply_reference
from tensorkrylov_tpu_torch.ops.ring_spmv import make_ring_spmv, ring_spmv_local, ring_spmv_reference
from tensorkrylov_tpu_torch.parallel import gather, make_mesh, shard_operator, shard_rhs, solve_sharded
from tensorkrylov_tpu_torch.parallel import halo as halo_mod
from tensorkrylov_tpu_torch.parallel.halo import exchange_halos, spmv_sharded

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _op(offsets, d, n, seed, dtype, device):
    bands = np.random.default_rng(seed).uniform(-1.0, 1.0, (d, len(offsets), n))
    for b, off in enumerate(offsets):
        if off > 0:
            bands[:, b, n - off:] = 0.0
        elif off < 0:
            bands[:, b, :-off] = 0.0
    return tkt.KroneckerSumOperator(torch.tensor(bands, dtype=dtype, device=device), offsets)


@pytest.mark.parametrize("shape", [(3, 1001), (3, 4, 1001), (10, 131072), (10, 63, 131072)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_kernel_equals_plain(cuda, dtype, shape):
    """Same products, summed in the same order, each rounded: equal bits;
    (10, 63, 131072) is one kron_apply_cp of a rank-63 solution at the main
    path's width."""
    op = _op((-2, -1, 0, 1, 2), shape[0], shape[-1], 0, dtype, cuda)
    v = torch.randn(shape, dtype=dtype, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = _build.launches["banded_spmv"]
    got = spmv(op, v)
    torch.cuda.synchronize()
    assert _build.launches["banded_spmv"] == before + 1
    assert torch.equal(got, spmv_reference(op, v))


@pytest.mark.parametrize("n", [50001, 131072])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_kernel_matches_plain(cuda, dtype, n):
    """Each operation rounded on its own and the sums taken in the kernel's
    fixed order on both sides: equal bits, from the CPU too."""
    d = 4
    op = _op((-1, 0, 1), d, n, 2, dtype, cuda)
    g = torch.Generator(cuda).manual_seed(3)
    v_prev, v_pprev, b = (torch.randn((d, n), dtype=dtype, device=cuda, generator=g) for _ in range(3))
    beta = torch.rand(d, dtype=dtype, device=cuda, generator=g)
    got = fused_lanczos_core(op, v_prev, v_pprev, beta, b)
    ref = fused_lanczos_core_reference(op, v_prev, v_pprev, beta, b)
    assert all(torch.equal(a, x) for a, x in zip(got, ref))
    cpu_op = tkt.KroneckerSumOperator(op.bands.cpu(), op.offsets)
    on_cpu = fused_lanczos_core(cpu_op, *(t.cpu() for t in (v_prev, v_pprev, beta, b)))
    assert all(torch.equal(a.cpu(), x) for a, x in zip(got, on_cpu))
    # fixed reduction trees, no atomics: a second launch repeats bit for bit
    again = fused_lanczos_core(op, v_prev, v_pprev, beta, b)
    assert all(torch.equal(a, x) for a, x in zip(got, again))


class _EntryRecorder:
    """The kernel library, recording the names of the entry points called whose name starts with prefix."""

    def __init__(self, prefix):
        self.lib, self.prefix, self.calls = _build.kernels(), prefix, []

    def __getattr__(self, name):
        if name.startswith(self.prefix):
            self.calls.append(name)
        return getattr(self.lib, name)


FUSED_CASES = {  # d, n
    "n50001": (4, 50001),
    "n131072": (4, 131072),
    "w_past_shared": (2, 1 << 20),  # a block's part of w (256 chunks at G=16) is past W_SHARED_BYTES: u's row
}


@pytest.mark.parametrize("w_in", ["shared", "u_row"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_placements_one_launch(cuda, monkeypatch, dtype, case, w_in):
    """w kept in shared memory or in u's row (forced, or because a block's
    part does not fit): the plain version's bits either way, in one launch
    per call."""
    if w_in == "u_row":
        monkeypatch.setattr(fused_lanczos, "W_SHARED_BYTES", 0)
    d, n = FUSED_CASES[case]
    op = _op((-1, 0, 1), d, n, 40, dtype, cuda)
    g = torch.Generator(cuda).manual_seed(41)
    v_prev, v_pprev, b = (torch.randn((d, n), dtype=dtype, device=cuda, generator=g) for _ in range(3))
    beta = torch.rand(d, dtype=dtype, device=cuda, generator=g)
    G = fused_lanczos.fused_lanczos_plan(d, n, dtype, cuda)
    assert (fused_lanczos._w_bytes(n, G, dtype.itemsize) > 0) == (w_in == "shared" and case != "w_past_shared")
    recorder = _EntryRecorder("tk_fused_lanczos_f")
    monkeypatch.setattr(_build, "kernels", lambda: recorder)
    before = _build.launches["fused_lanczos"]
    got = fused_lanczos_core(op, v_prev, v_pprev, beta, b)
    torch.cuda.synchronize()
    assert recorder.calls == ["tk_fused_lanczos_f64" if dtype == torch.float64 else "tk_fused_lanczos_f32"]
    assert _build.launches["fused_lanczos"] == before + 1
    assert all(torch.equal(a, r) for a, r in zip(got, fused_lanczos_core_reference(op, v_prev, v_pprev, beta, b)))


@pytest.mark.parametrize("w_in", ["shared", "u_row"])
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_fused_cluster_sizes_equal_plain(cuda, monkeypatch, G, w_in):
    """Every cluster size gives the plain version's bits: chunk ownership by
    blocks leaves the fixed summation order alone."""
    if w_in == "u_row":
        monkeypatch.setattr(fused_lanczos, "W_SHARED_BYTES", 0)
    monkeypatch.setattr(fused_lanczos, "fused_lanczos_plan", lambda d, n, dtype, device=None: G)
    d, n = 3, 20011
    op = _op((-5, -2, 0, 3, 5), d, n, 42, torch.float64, cuda)
    g = torch.Generator(cuda).manual_seed(43)
    v_prev, v_pprev, b = (torch.randn((d, n), dtype=torch.float64, device=cuda, generator=g) for _ in range(3))
    beta = torch.rand(d, dtype=torch.float64, device=cuda, generator=g)
    got = fused_lanczos_core(op, v_prev, v_pprev, beta, b)
    assert all(torch.equal(a, r) for a, r in zip(got, fused_lanczos_core_reference(op, v_prev, v_pprev, beta, b)))


@pytest.mark.parametrize("basis_dtype", [torch.float32, torch.float64])
def test_fused_recurrence_equals_cpu(cuda, basis_dtype):
    """Without reorthogonalization rounding grows from step to step, so the
    fused recurrence must give the same bits on the card as on the CPU."""
    from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_step

    op = tkt.reaction_diffusion(3, 5000, 1e6, device="cpu")
    b = tkt.random_rhs(3, 5000, seed=5, identical=False)
    out = {}
    for dev in ("cpu", cuda):
        dop = tkt.KroneckerSumOperator(op.bands.to(dev).to(basis_dtype), op.offsets)
        st, _ = init_state(dop, b.to(dev), 30, torch.float64, basis_dtype)
        for k in range(1, 31):
            st, _ = lanczos_step(dop, st, b.to(dev), k, reorth=False, proj_dtype=torch.float64, fused=True)
        out[str(dev)] = [t.cpu() for t in st]
    assert all(torch.equal(a, c) for a, c in zip(out["cpu"], out[str(cuda)]))


def test_kernel_wrappers_reject_bad_input(cuda):
    op = _op((-1, 0, 1), 2, 64, 4, torch.float64, cuda)
    with pytest.raises(TypeError):
        spmv(op, torch.ones((2, 64), dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        spmv(op, torch.ones((2, 128), dtype=torch.float64, device=cuda)[:, ::2])
    v = torch.ones((2, 64), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        fused_lanczos_core(op, v, v, torch.ones(3, dtype=torch.float64, device=cuda), v)


@pytest.mark.parametrize("fields,kernel", [
    (dict(), "banded_spmv"),
    (dict(orth="lanczos_reorth_auto", step_impl="fused"), "fused_lanczos"),
])
def test_solve_on_card_goes_through_kernel(cuda, fields, kernel):
    op = tkt.laplace(3, 30, device=cuda)
    b = tkt.random_rhs(3, 30, seed=7, device=cuda)
    _build.launches.clear()
    res = tkt.solve(op, b, tkt.SolverConfig(kmax=30, tol=1e-8, **fields))
    assert res.status == tkt.Status.CONVERGED
    assert _build.launches[kernel] == res.niterations
    assert tkt.kron_residual_dense(op, res.x, b) <= 1e-8


def test_golden_on_card(cuda):
    """tests/golden_laplace_d4_n100.json reproduced on the card: its status,
    steps and relative-residual trace within 1e-6."""
    import json
    import os

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_laplace_d4_n100.json")) as f:
        g = json.load(f)
    op = tkt.laplace(g["d"], g["n"], device=cuda)
    b = tkt.random_rhs(g["d"], g["n"], seed=g["seed"], device=cuda)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    res = tkt.solve(op, b, tkt.SolverConfig(kmax=g["n"], tol=g["tol"], orth=g["orth"]))
    assert (res.status, res.niterations) == (g["status"], g["niterations"])
    np.testing.assert_allclose(res.relative_residual[1:g["niterations"] + 1].cpu().numpy(), g["relative_residual"],
                               rtol=1e-6)


@pytest.mark.parametrize("fields", [dict(), dict(orth="lanczos_reorth_auto", step_impl="fused")],
                         ids=["default", "fused"])
def test_solve_on_card_equals_cpu(cuda, fields):
    """The κ = 1e2 cells' solve at d=10, n=4096 on the card and on the CPU,
    both through the tridiagonal eigensolver (its plain version on the CPU):
    the same status and steps, the residual trace within 1e-6 and the λ
    traces within 1e-12."""
    cfg = tkt.SolverConfig(kmax=200, tol=1e-8, eigh_impl="tridiag_mixed", **fields)
    ref = tkt.solve(*_rd_problem("cpu", 4096, 1e2), cfg)
    got = tkt.solve(*_rd_problem(cuda, 4096, 1e2), cfg)
    _traces_close(got, ref, 1e-6)
    k = got.niterations
    for f in ("lambda_min", "lambda_max"):
        np.testing.assert_allclose(getattr(got, f)[1:k + 1].cpu().numpy(), getattr(ref, f)[1:k + 1].numpy(),
                                   rtol=1e-12, err_msg=f)


def _unit_rows(d, n, seed, device):
    v = torch.randn((d, n), dtype=torch.float64, generator=torch.Generator().manual_seed(seed))
    return (v / torch.linalg.vector_norm(v, dim=1, keepdim=True)).float().to(device)


@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-5, -2, 0, 3, 5)], ids=["tri", "wide"])
@pytest.mark.parametrize("n", [1001, 4099])
def test_resident_kernel_equals_plain(cuda, n, offsets):
    """Ragged n and offsets past the TPU kernel's rules: the kernel equals its
    plain version, on the card and on the CPU, in all six outputs."""
    d, S = 3, 8
    op = _op(offsets, d, n, 6, torch.float32, cuda)
    vp = _unit_rows(d, n, 7, cuda)
    vpp, beta = torch.zeros_like(vp), torch.zeros(d, dtype=torch.float32, device=cuda)
    before = _build.launches["resident_lanczos"]
    got = lanczos_resident_steps(op, vp, vpp, beta, S)
    torch.cuda.synchronize()
    assert _build.launches["resident_lanczos"] == before + 1
    ref = lanczos_resident_steps_reference(op, vp, vpp, beta, S)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    cpu_op = tkt.KroneckerSumOperator(op.bands.cpu(), op.offsets)
    on_cpu = lanczos_resident_steps(cpu_op, vp.cpu(), vpp.cpu(), beta.cpu(), S)
    assert all(torch.equal(a.cpu(), c) for a, c in zip(got, on_cpu))


def test_resident_recurrence_equals_cpu(cuda):
    """30 steps in segments of 8, 8, 8 and 6 through the solver's segment
    update: the f32 basis and H are the same bits on the card and the CPU."""
    from tensorkrylov_tpu_torch.ops.orth import init_state
    from tensorkrylov_tpu_torch.solver import _resident_segment_update

    op = tkt.reaction_diffusion(3, 5000, 1e6, dtype=torch.float32, device="cpu")
    b = tkt.random_rhs(3, 5000, seed=5, identical=False)
    out = {}
    for dev in ("cpu", cuda):
        dop = tkt.KroneckerSumOperator(op.bands.to(dev), op.offsets)
        st, _ = init_state(dop, b.to(dev), 30, torch.float64, torch.float32)
        for k0 in (1, 9, 17, 25):
            st = _resident_segment_update(dop, st, b.to(dev), k0, min(8, 31 - k0))
        out[str(dev)] = [t.cpu() for t in st]
    cpu, card = out["cpu"], out[str(cuda)]
    assert torch.equal(cpu[0], card[0]) and torch.equal(cpu[1], card[1]) and torch.equal(cpu[3], card[3])
    # b̃ = ⟨v_j, b⟩ sums the f32 products in f64, in cuBLAS's order on the card
    torch.testing.assert_close(card[2], cpu[2], rtol=0, atol=1e-13 * float(cpu[2].abs().max()))


RESIDENT_CASES = {  # d, n, offsets
    "ragged": (3, 4099, (-5, -2, 0, 3, 5)),
    "n_below_G_chunks": (2, 300, (-1, 0, 1)),   # 2 chunks: most blocks of a cluster own none
    "d20_queued": (20, 20011, (-1, 0, 1)),     # more clusters than the card holds at once
}


def _resident_equal(got, ref):
    return all(torch.equal(a, r) for a, r in zip(got, ref))


def _force_cluster(monkeypatch, G):
    """The resident kernel's launches take G blocks per factor, whatever the plan says."""
    monkeypatch.setattr(resident_lanczos, "resident_lanczos_plan", lambda d, n, device=None: G)


@pytest.mark.parametrize("u_in", ["shared", "l2"])
@pytest.mark.parametrize("case", sorted(RESIDENT_CASES))
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_resident_cluster_sizes_equal_plain(cuda, monkeypatch, G, case, u_in):
    """Every cluster size gives the plain version's bits, with u in shared
    memory or in the scratch row: chunk ownership by blocks leaves the fixed
    summation order alone; one launch each."""
    if u_in == "l2":
        monkeypatch.setattr(resident_lanczos, "U_SHARED_BYTES", 0)
    _force_cluster(monkeypatch, G)
    d, n, offsets = RESIDENT_CASES[case]
    op = _op(offsets, d, n, 31, torch.float32, cuda)
    vp = _unit_rows(d, n, 32, cuda)
    vpp, beta = torch.zeros_like(vp), torch.zeros(d, dtype=torch.float32, device=cuda)
    before = _build.launches["resident_lanczos"]
    got = lanczos_resident_steps(op, vp, vpp, beta, 9)
    torch.cuda.synchronize()
    assert _build.launches["resident_lanczos"] == before + 1
    assert _resident_equal(got, lanczos_resident_steps_reference(op, vp, vpp, beta, 9))


@pytest.mark.parametrize("S", [0, 1, 2, 33])
def test_resident_step_counts_equal_plain(cuda, S):
    """S = 0 launches nothing and returns the carries; 1, 2 and 33 steps
    (past the slab of columns one segment writes) equal the plain version."""
    d, n = 3, 5003
    op = tkt.reaction_diffusion(d, n, 1e4, dtype=torch.float32, device=cuda)
    vp = _unit_rows(d, n, 33, cuda)
    vpp, beta = torch.zeros_like(vp), torch.zeros(d, dtype=torch.float32, device=cuda)
    before = _build.launches["resident_lanczos"]
    got = lanczos_resident_steps(op, vp, vpp, beta, S)
    torch.cuda.synchronize()
    assert _build.launches["resident_lanczos"] == before + (S > 0)
    assert tuple(got.V.shape) == (S, d, n) and tuple(got.alpha.shape) == (d, S)
    assert _resident_equal(got, lanczos_resident_steps_reference(op, vp, vpp, beta, S))


@pytest.mark.parametrize("G", [1, 8])
def test_resident_freeze_on_card(cuda, monkeypatch, G):
    """An eigenvector start freezes its factor (zero columns, β' = 0) on the
    card as in the plain version; the other factor runs on."""
    d, n = 2, 16
    op = tkt.eigval_matrix(np.stack([np.arange(1.0, n + 1), np.linspace(1.0, 3.0, n)]), dtype=torch.float32,
                           device=cuda)
    vp = torch.zeros((d, n), dtype=torch.float32, device=cuda)
    vp[0, 3] = 1.0
    vp[1] = 1.0 / np.sqrt(n)
    vpp, beta = torch.zeros_like(vp), torch.zeros(d, dtype=torch.float32, device=cuda)
    _force_cluster(monkeypatch, G)
    got = lanczos_resident_steps(op, vp, vpp, beta, 4)
    assert _resident_equal(got, lanczos_resident_steps_reference(op, vp, vpp, beta, 4))
    assert torch.count_nonzero(got.V[:, 0]) == 0 and float(got.beta_last[0]) == 0.0
    assert bool(torch.all(got.beta[1] > 0.1))


@pytest.mark.parametrize("G", [2, 16])
def test_resident_out_slab_on_card(cuda, monkeypatch, G):
    """out= writes the columns into a slab of a larger basis and nothing
    else of it."""
    d, n = 3, 4099
    op = tkt.laplace(d, n, shift=3.0, dtype=torch.float32, device=cuda)
    vp = _unit_rows(d, n, 34, cuda)
    vpp, beta = torch.zeros_like(vp), torch.zeros(d, dtype=torch.float32, device=cuda)
    V = torch.zeros((6, d, n), dtype=torch.float32, device=cuda)
    _force_cluster(monkeypatch, G)
    got = lanczos_resident_steps(op, vp, vpp, beta, 4, out=V[1:5])
    assert got.V.data_ptr() == V[1].data_ptr()
    assert torch.equal(V[1:5], lanczos_resident_steps_reference(op, vp, vpp, beta, 4).V)
    assert torch.count_nonzero(V[0]) == 0 and torch.count_nonzero(V[5]) == 0


def test_resident_plan_on_card(cuda):
    """At the host-projected slice's shape the plan spreads each factor over
    a cluster (G > 1) that the card can hold."""
    G = resident_lanczos_plan(10, 131072, cuda)
    assert G in _cluster.CLUSTER_SIZES and G > 1
    assert resident_lanczos._max_active_clusters(G, torch.cuda.current_device(), resident_lanczos._u_bytes(131072, G)) >= 1


def test_resident_wrapper_rejects_bad_input(cuda):
    op = _op((-1, 0, 1), 2, 64, 4, torch.float32, cuda)
    v = torch.ones((2, 64), dtype=torch.float32, device=cuda)
    beta = torch.zeros(2, dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        lanczos_resident_steps(op.astype(torch.float64), v, v, beta, 2)
    with pytest.raises(TypeError):
        lanczos_resident_steps(op, v.double(), v, beta, 2)
    with pytest.raises(ValueError):
        lanczos_resident_steps(op, torch.ones((2, 128), dtype=torch.float32, device=cuda)[:, ::2], v, beta, 2)
    with pytest.raises(ValueError):
        lanczos_resident_steps(op, v, v, torch.zeros(3, dtype=torch.float32, device=cuda), 2)
    with pytest.raises(ValueError):
        lanczos_resident_steps(op, v, v, beta, 2, out=torch.empty((3, 2, 64), dtype=torch.float32, device=cuda))


@pytest.mark.parametrize("step_impl,kernel", [("resident", "resident_lanczos"), ("xla", "banded_spmv")])
def test_host_projected_on_card_goes_through_kernel(cuda, step_impl, kernel):
    """The resident route launches its kernel once per segment; the unfused
    route launches the SpMV kernel once per step."""
    op = tkt.reaction_diffusion(3, 300, 2e4, dtype=torch.float32, device=cuda)
    b = tkt.random_rhs(3, 300, seed=7, device=cuda)
    # plain f32 Lanczos: the estimate floors near 1e-5 here, so tol is 1e-4 (16 steps on the CPU)
    cfg = tkt.SolverConfig(kmax=40, tol=1e-4, orth="lanczos", basis_dtype=torch.float32, check_every=8,
                           step_impl=step_impl)
    _build.launches.clear()
    res = tkt.solve_host_projected(op, b, cfg)
    assert res.config.step_impl == step_impl and res.status == tkt.Status.CONVERGED
    segments = -(-res.niterations // 8)
    assert _build.launches[kernel] == (segments if step_impl == "resident" else res.niterations)
    assert res.x.factors.is_cuda and bool(torch.isfinite(res.x.factors).all())


def _checked(res):
    """The steps at which a check recorded a residual."""
    r = res.relative_residual.cpu().numpy()
    return np.flatnonzero(np.isfinite(r) & (r > 0))


def test_host_projected_routes_and_cpu_on_card(cuda):
    """solve_host_projected with plain f32 Lanczos (check every 8, kmax 200)
    on the κ = 1e2 slice: at n=131072 the unfused route's λ traces within
    1e-4 of the resident route's (two f32 roundings) and its residual trace
    within a factor of 2 (past the f32 floor near k = 24 each route's
    rounding drives its own drift), the same status; at n=4096 the resident
    route on the card equals the CPU's (status and steps, the traces within
    1e-6, λ within 1e-12), and the CPU launches no kernel."""
    cfg = dict(kmax=200, tol=1e-8, orth="lanczos", basis_dtype=torch.float32, check_every=8)
    op, b = _rd_problem(cuda, 131072, 1e2)
    routes = {}
    for impl in ("resident", "xla"):
        res = tkt.solve_host_projected(op, b, tkt.SolverConfig(**cfg, step_impl=impl))
        assert bool(torch.isfinite(res.x.factors).all())
        routes[impl] = dataclasses.replace(res, x=None)
    a, c = routes["resident"], routes["xla"]
    assert a.status == c.status
    idx = np.intersect1d(_checked(a), _checked(c))
    for f, rtol in (("lambda_min", 1e-4), ("lambda_max", 1e-4), ("relative_residual", 1.0)):
        np.testing.assert_allclose(getattr(a, f).numpy()[idx], getattr(c, f).numpy()[idx], rtol=rtol, err_msg=f)
    del op, b, routes
    _build.launches.clear()
    cpu = tkt.solve_host_projected(*_rd_problem("cpu", 4096, 1e2), tkt.SolverConfig(**cfg, step_impl="resident"))
    assert not any(_build.launches.values())
    got = tkt.solve_host_projected(*_rd_problem(cuda, 4096, 1e2), tkt.SolverConfig(**cfg, step_impl="resident"))
    assert (got.status, got.niterations) == (cpu.status, cpu.niterations)
    idx = _checked(cpu)
    for f, rtol in (("relative_residual", 1e-6), ("lambda_min", 1e-12), ("lambda_max", 1e-12)):
        np.testing.assert_allclose(getattr(got, f).numpy()[idx], getattr(cpu, f).numpy()[idx], rtol=rtol, err_msg=f)


@pytest.mark.parametrize("entry", ["solve", "solve_host_projected"])
def test_arnoldi_conv_diff_on_card(cuda, entry):
    """The verify recipe on the card: the dense-oracle residual is ≤ 1e-8."""
    op = tkt.conv_diff(3, 30, device=cuda)
    b = tkt.random_rhs(3, 30, seed=7, device=cuda)
    _build.launches.clear()
    res = getattr(tkt, entry)(op, b, tkt.SolverConfig(kmax=30, tol=1e-8, orth="arnoldi", tmax=601))
    assert res.status == tkt.Status.CONVERGED and _build.launches["banded_spmv"] == res.niterations
    assert tkt.kron_residual_dense(op, res.x, b) <= 1e-8


@pytest.mark.slow
def test_host_projected_conv_diff_at_width_on_card(cuda):
    """solve_host_projected on conv_diff at d=10, n=16384, κ = 1e4 through
    Arnoldi (kmax 384, tmax 801, check every 16): converged, x of rank tmax
    finite, one banded_spmv launch per step."""
    n = 16384
    op = tkt.conv_diff(10, n, shift=_sigma_for_kappa(n, 1e4), device=cuda)
    b = tkt.random_rhs(10, n, seed=1234, device=cuda)
    cfg = tkt.SolverConfig(kmax=384, tol=1e-8, orth="arnoldi", tmax=801, check_every=16)
    _build.launches.clear()
    res = tkt.solve_host_projected(op, b / torch.linalg.vector_norm(b, dim=1, keepdim=True), cfg)
    torch.cuda.synchronize()
    assert res.status == tkt.Status.CONVERGED and _build.launches["banded_spmv"] == res.niterations
    assert tuple(res.x.factors.shape) == (10, n, 801) and bool(torch.isfinite(res.x.factors).all())


def _dominant_op(offsets, d, n, seed, dtype, device):
    """Distinct random factors with a dominant diagonal (offset 0 in offsets):
    the spectral radius stays near the largest row sum, so hundreds of scaled
    applies neither vanish nor blow up."""
    op = _op(offsets, d, n, seed, torch.float64, "cpu")
    bands = op.bands.clone()
    bands[:, offsets.index(0)] = 16.0 + bands[:, offsets.index(0)].abs()
    return tkt.KroneckerSumOperator(bands.to(dtype).to(device), offsets, False)


RESIDENT_OPS = {  # the kernel's instantiations: centred 3 bands, centred 5 bands, generic (the rest)
    "laplace": lambda d, n, dtype, dev: tkt.laplace(d, n, dtype=dtype, device=dev),
    "conv_diff": lambda d, n, dtype, dev: tkt.conv_diff(d, n, dtype=dtype, device=dev),
    "penta_distinct": lambda d, n, dtype, dev: _dominant_op((-2, -1, 0, 1, 2), d, n, 12, dtype, dev),
    "wide_distinct": lambda d, n, dtype, dev: _dominant_op((-3, -1, 0, 2, 5), d, n, 8, dtype, dev),
    "seven_distinct": lambda d, n, dtype, dev: _dominant_op((-3, -2, -1, 0, 1, 2, 3), d, n, 13, dtype, dev),
    # the generic span is the shared memory's: more than 16 bands, and a half-width past 511
    "seventeen_distinct": lambda d, n, dtype, dev: _dominant_op(tuple(range(-8, 9)), d, n, 14, dtype, dev),
    "half_width_512": lambda d, n, dtype, dev: _dominant_op((-512, -1, 0, 1, 512), d, n, 15, dtype, dev),
}


@pytest.mark.parametrize("m_case", ["1", "M-1", "M", "2M+3"])
@pytest.mark.parametrize("gallery", sorted(RESIDENT_OPS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resident_spmv_equals_plain(cuda, dtype, gallery, m_case):
    """Bit-equal to its plain version for m below, at and past the applies per
    launch M, with n = 2T + 333 (tile seams and a ragged last tile), launched
    ceil(m/M) times."""
    make = RESIDENT_OPS[gallery]
    M, T = resident_spmv_plan(make(3, 64, dtype, cuda))
    n = 2 * T + 333
    op = make(3, n, dtype, cuda)
    assert resident_spmv_plan(op) == (M, T)
    m = {"1": 1, "M-1": M - 1, "M": M, "2M+3": 2 * M + 3}[m_case]
    scale = float(1.0 / op.bands.abs().sum(1).max())
    v = torch.randn((3, n), dtype=dtype, device=cuda, generator=torch.Generator(cuda).manual_seed(9))
    before = _build.launches["resident_spmv"]
    got = spmv_multi_apply(op, v, m, scale)
    torch.cuda.synchronize()
    assert _build.launches["resident_spmv"] == before + -(-m // M)
    ref = spmv_multi_apply_reference(op, v, m, scale)
    assert bool(ref.abs().max() > 1e-20)  # the applies did not vanish
    assert torch.equal(got, ref)


@pytest.mark.parametrize("gallery", ["laplace", "penta_distinct"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resident_spmv_forced_generic_equals_plain(cuda, monkeypatch, dtype, gallery):
    """The centred 3- and 5-band operators forced onto the generic
    instantiation: the plain version's bits, m past two launches."""
    from tensorkrylov_tpu_torch.ops import resident_spmv as rs

    monkeypatch.setattr(rs, "_centred", lambda op: False)
    make = RESIDENT_OPS[gallery]
    M, T = resident_spmv_plan(make(3, 64, dtype, cuda))
    op = make(3, 2 * T + 333, dtype, cuda)
    m = 2 * M + 3
    scale = float(1.0 / op.bands.abs().sum(1).max())
    v = torch.randn((3, op.n), dtype=dtype, device=cuda, generator=torch.Generator(cuda).manual_seed(9))
    ref = spmv_multi_apply_reference(op, v, m, scale)
    assert bool(ref.abs().max() > 1e-20) and torch.equal(spmv_multi_apply(op, v, m, scale), ref)


def test_resident_spmv_small_n_and_zero_applies(cuda):
    """n below one tile and below the halo; m = 0 launches nothing."""
    op = _dominant_op((-3, 0, 4), 2, 5, 10, torch.float32, cuda)
    v = torch.randn((2, 5), device=cuda, generator=torch.Generator(cuda).manual_seed(11))
    assert torch.equal(spmv_multi_apply(op, v, 7, 0.125), spmv_multi_apply_reference(op, v, 7, 0.125))
    before = _build.launches["resident_spmv"]
    assert torch.equal(spmv_multi_apply(op, v, 0), v) and _build.launches["resident_spmv"] == before


def test_resident_spmv_rejects_bad_input(cuda):
    op = _op((-1, 0, 1), 2, 64, 4, torch.float32, cuda)
    v = torch.ones((2, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        spmv_multi_apply(op, v.double(), 2)
    with pytest.raises(TypeError):
        spmv_multi_apply(op.astype(torch.float16), v.half(), 2)
    with pytest.raises(ValueError):
        spmv_multi_apply(op, torch.ones((3, 64), dtype=torch.float32, device=cuda), 2)
    with pytest.raises(ValueError):
        spmv_multi_apply(op, torch.ones((2, 128), dtype=torch.float32, device=cuda)[:, ::2], 2)
    with pytest.raises(ValueError):
        spmv_multi_apply(op, v, -1)
    with pytest.raises(ValueError, match="cannot take"):  # not one apply of one output fits in shared memory
        spmv_multi_apply(_op((-4000, 0, 4000), 2, 64, 4, torch.float32, cuda), v, 2)


RING_OFFSETS = {"tri": (-1, 0, 1), "penta": (-2, -1, 0, 1, 2), "wide": (-7, -2, 0, 3, 5)}


def _ring_on(devices, op, v):
    """The sharded ring SpMV of v over a mode mesh of the given devices:
    (per-shard results, the sharded operator, the per-shard inputs)."""
    mesh = make_mesh(devices=devices)
    sop = shard_operator(op, mesh, "ring")
    vs = shard_rhs(v, mesh)
    return spmv_sharded(sop, vs), sop, vs


@pytest.mark.parametrize("shape", ["dn", "dmn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("band", sorted(RING_OFFSETS))
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_ring_kernel_equals_plain(cuda, P, band, dtype, shape):
    """P shards of 1003 columns on cuda:0: one launch for all of them, and
    each shard's result equals the plain version on the same halos, on the
    card and on the CPU, bit for bit."""
    offsets, d = RING_OFFSETS[band], 3
    n = 1003 * P
    op = _op(offsets, d, n, 21, dtype, cuda)
    v = torch.randn((d, n) if shape == "dn" else (d, 4, n), dtype=dtype, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(22))
    before = _build.launches["ring_spmv"]
    got, sop, vs = _ring_on([cuda] * P, op, v)
    torch.cuda.synchronize()
    assert _build.launches["ring_spmv"] == before + 1
    halos, _ = exchange_halos(sop, vs)
    torch.cuda.synchronize()
    for sh, vi, (lh, rh), g in zip(sop.shards, vs, halos, got):
        assert torch.equal(g, ring_spmv_reference(sh.op, vi, lh, rh))
    on_cpu = make_ring_spmv(make_mesh(devices=[torch.device("cpu")] * P), offsets)(op.bands.cpu(), v.cpu())
    assert torch.equal(gather(got, sop.mesh).cpu(), on_cpu)


def test_ring_one_launch_per_card(cuda, monkeypatch):
    """4 shards of one card: one call of the kernel's entry point per sharded
    SpMV, one count, no halo exchange and no side stream; the result equals
    the CPU route's bit for bit."""
    recorder = _EntryRecorder("tk_ring_spmv_f")
    op = _op(RING_OFFSETS["penta"], 3, 4 * 1000, 29, torch.float64, cuda)
    v = torch.randn((3, 4 * 1000), dtype=torch.float64, device=cuda, generator=torch.Generator(cuda).manual_seed(30))
    on_cpu = make_ring_spmv(make_mesh(devices=[torch.device("cpu")] * 4), RING_OFFSETS["penta"])(op.bands.cpu(),
                                                                                               v.cpu())
    monkeypatch.setattr(_build, "kernels", lambda: recorder)
    monkeypatch.setattr(halo_mod, "exchange_halos", lambda *a: pytest.fail("the ring route exchanged halos"))
    before = _build.launches["ring_spmv"]
    got, sop, _ = _ring_on([cuda] * 4, op, v)
    torch.cuda.synchronize()
    assert recorder.calls == ["tk_ring_spmv_f64"]
    assert _build.launches["ring_spmv"] == before + 1
    assert all(sh.side is None for sh in sop.shards) and not sop.halo_buffers
    assert torch.equal(gather(got, sop.mesh).cpu(), on_cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ring_kernel_shard_exactly_halo_wide(cuda, dtype):
    """8 shards of 7 columns with H = 7: every column is an edge column."""
    offsets = RING_OFFSETS["wide"]
    op = _op(offsets, 2, 56, 23, dtype, cuda)
    v = torch.randn((2, 56), dtype=dtype, device=cuda, generator=torch.Generator(cuda).manual_seed(24))
    got, sop, _ = _ring_on([cuda] * 8, op, v)
    on_cpu = make_ring_spmv(make_mesh(devices=[torch.device("cpu")] * 8), offsets)(op.bands.cpu(), v.cpu())
    assert torch.equal(gather(got, sop.mesh).cpu(), on_cpu)


# one rank of test_ring_two_processes: 2 slots of its card, layout 'mode' across the ranks
_RING_RANK = """
import hashlib, sys
import numpy as np, torch
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.ops import _build
from tensorkrylov_tpu_torch.parallel import distribute_problem, gather, init_distributed, make_pod_mesh
from tensorkrylov_tpu_torch.parallel.halo import spmv_sharded
init_distributed(f"localhost:{sys.argv[1]}", 2, int(sys.argv[2]), 2)
bands = torch.tensor(np.load(sys.argv[3]), device="cuda:0")
op = tkt.KroneckerSumOperator(bands, (-2, -1, 0, 1, 2))
v = torch.tensor(np.load(sys.argv[4]), device="cuda:0")
sop, vs = distribute_problem(op, v, make_pod_mesh(factor_parallel=1), "ring")
_build.launches.clear()
us = spmv_sharded(sop, vs)
torch.cuda.synchronize()
launches = dict(_build.launches)
u = gather(us, sop.mesh)
print("RING", torch.distributed.get_backend(), launches, hashlib.sha256(u.cpu().numpy().tobytes()).hexdigest())
"""


@pytest.mark.parametrize("cards", [1, 2])
def test_ring_two_processes(cuda, tmp_path, cards):
    """Two ranks, each owning 2 of 4 mode shards of a pentadiagonal operator,
    on cuda:0 (cards=1: gloo, the ranks share the card) or on a card each
    (cards=2: NCCL): each rank launches the ring kernel once, reading the
    other rank's edge from a received halo buffer, and the gathered result
    equals the single-process ring SpMV bit for bit."""
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} CUDA devices")
    import hashlib
    import sys

    offsets = RING_OFFSETS["penta"]
    op = _op(offsets, 3, 4 * 1000, 31, torch.float64, cuda)
    v = torch.randn((3, 4 * 1000), dtype=torch.float64, device=cuda, generator=torch.Generator(cuda).manual_seed(32))
    got, sop, _ = _ring_on([cuda] * 4, op, v)
    want = hashlib.sha256(gather(got, sop.mesh).cpu().numpy().tobytes()).hexdigest()
    np.save(tmp_path / "bands.npy", op.bands.cpu().numpy())
    np.save(tmp_path / "v.npy", v.cpu().numpy())
    port = str(_free_port())
    outs = _processes([[sys.executable, "-c", _RING_RANK, port, str(r), str(tmp_path / "bands.npy"),
                        str(tmp_path / "v.npy")] for r in range(2)], timeout=180, first_card_only=cards == 1)
    for out in outs:
        line = next(ln for ln in out.splitlines() if ln.startswith("RING "))
        assert line == f"RING {'gloo' if cards == 1 else 'nccl'} {{'ring_spmv': 1}} {want}", line


def _processes(argvs, timeout=300, first_card_only=True):
    """Run one process per argv from the repository's root (on the first card
    alone unless first_card_only is false), kill them all at the timeout;
    their stdouts, each having exited 0."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if first_card_only:
        env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=repo)
             for a in argvs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in outs]


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


# one process of test_two_ranks_on_card_equal_one_controller: rank 0 or 1 of two, each owning 2 slots of cuda:0,
# or (rank -1) one controller over 4 slots; prints each case's status, steps, checks, digests, launches and traffic
_CASES_PROCESS = """
import hashlib, json, sys
import numpy as np, torch
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.ops import _build
from tensorkrylov_tpu_torch.parallel import init_distributed, make_mesh, make_pod_mesh, shard_operator, shard_rhs
from tensorkrylov_tpu_torch.parallel.sharding import comm_stats
rank = int(sys.argv[2])
if rank >= 0:
    init_distributed(f"localhost:{sys.argv[1]}", 2, rank, 2)
dev = torch.device("cuda", 0)
mesh_of = (lambda fp: make_pod_mesh(factor_parallel=fp)) if rank >= 0 else (
    lambda fp: make_mesh(devices=[dev] * 4, factor_parallel=fp))

def unit(b):
    return (b / torch.linalg.vector_norm(b, dim=1, keepdim=True)).to(dev)

def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(torch.as_tensor(t).detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()

def run(solve):
    torch.cuda.synchronize()
    _build.launches.clear()
    comm_stats.clear()
    res = solve()
    torch.cuda.synchronize()
    k = res.niterations
    if torch.is_tensor(res.relative_residual):
        r = res.relative_residual.cpu().numpy()
        trace, checks = digest(res.relative_residual[:k + 1]), int((np.isfinite(r) & (r > 0)).sum())
    else:
        trace, checks = digest(res.relative_residual + res.certified_bound), len(res.checkpoints)
    return dict(status=int(res.status), k=k, checks=checks, trace=trace, x=digest(res.x.weights, res.x.factors),
                spectrum=digest(res.lambda_min, res.lambda_max),
                launches=dict(_build.launches), traffic={c: v for c, v in comm_stats.items() if c.endswith("_calls")})

n = 4096
lmax, lmin = (4.0 * (n + 1) ** 2 * np.sin(j * np.pi / (2 * (n + 1))) ** 2 for j in (n, 1))
rd = tkt.reaction_diffusion(10, n, float((lmax - 1e2 * lmin) / (1e2 - 1.0)), device="cpu")
op, b = tkt.KroneckerSumOperator(rd.bands.to(dev), rd.offsets), unit(tkt.random_rhs(10, n, seed=1234))
cfg = tkt.SolverConfig(kmax=200, tol=1e-8)
out = {}
for name, fp, comm in (("ring_factor2x2", 2, "ring"), ("ring", 1, "ring"), ("gspmd", 1, "gspmd")):
    mesh = mesh_of(fp)
    sop, bs = shard_operator(op, mesh, comm), shard_rhs(b, mesh, op.d)
    out[name] = dict(run(lambda: tkt.solve(sop, bs, cfg)), factor_parallel=fp)
dop, db = tkt.laplace(3, 256, shift=3000.0, device=dev), unit(tkt.random_rhs(3, 256, seed=5))
out["deflated"] = dict(run(lambda: tkt.solve_deflated(dop, db, tkt.SolverConfig(kmax=48, tol=1e-8), m=8,
                                                      storage="twopass", checkpoints=[16, 32, 48], mesh=mesh_of(1),
                                                      comm="ring")), factor_parallel=1)
print("CASES " + json.dumps(out))
"""


def test_two_ranks_on_card_equal_one_controller(cuda):
    """Two ranks on cuda:0 over gloo, 2 shard slots each (init_distributed,
    make_pod_mesh): the κ = 1e2 slice at n=4096 with 'factor' across the
    ranks (ring) and 'mode' across them (ring and gspmd, the halo between
    slots 1 and 2 crossing), and a deflated twopass on the ring route; each
    converges at one controller's step on 4 slots with the trace (or bounds),
    λ_min and λ_max (a solve's from H's α and β) and x bit-equal on both ranks and to
    it; each rank launches the ring
    kernel once per SpMV, or the SpMV kernel once per slot and SpMV, and the
    tridiagonal eigensolver once per check; 'mode' across the ranks exchanges
    one halo per SpMV, 'factor' none, and every case all-gathers."""
    import json
    import sys

    def cases(out):
        return json.loads(next(ln for ln in out.splitlines() if ln.startswith("CASES "))[6:])

    single = cases(_processes([[sys.executable, "-c", _CASES_PROCESS, "0", "-1"]])[0])
    port = str(_free_port())
    ranks = [cases(o) for o in _processes([[sys.executable, "-c", _CASES_PROCESS, port, str(r)] for r in range(2)])]
    for got_all in ranks:
        for name, ref in single.items():
            got, k = got_all[name], ref["k"]
            assert ref["status"] == tkt.Status.CONVERGED and (got["status"], got["k"]) == (ref["status"], k), name
            assert (got["trace"], got["x"], got["spectrum"]) == (ref["trace"], ref["x"], ref["spectrum"]), name
            if name == "deflated":   # both passes, the cross-check and the sup error on each rank
                want = {"ring_spmv": 2 * k - 1, "banded_spmv": 1, "expsum_sup": 1, "gram_dot2": 1}
            elif name == "gspmd":
                want = {"banded_spmv": 2 * k}
            else:
                want = {"ring_spmv": k}
            want["tridiag_eigh"] = got["checks"]
            assert got["launches"] == want, (name, got["launches"])
            traffic, spmvs = got["traffic"], want.get("ring_spmv", k)
            assert traffic.get("halo_calls", 0) == (spmvs if got["factor_parallel"] == 1 else 0), (name, traffic)
            assert traffic.get("psum_calls", 0) > 0 and traffic.get("gather_calls", 0) > 0, (name, traffic)


def test_parallel_smoke_two_ranks_on_card(cuda):
    """parallel/_smoke.py as two ranks on the card: both print the same
    SMOKE line, CONVERGED."""
    import sys

    port = _free_port()
    outs = _processes([[sys.executable, "-m", "tensorkrylov_tpu_torch.parallel._smoke", "--coordinator",
                        f"localhost:{port}", "--num-processes", "2", "--process-id", str(r), "--local-devices", "2"]
                       for r in range(2)])
    lines = [next((ln for ln in o.splitlines() if ln.startswith("SMOKE ")), None) for o in outs]
    assert lines[0] is not None and lines[0] == lines[1] and lines[0].startswith("SMOKE 1 "), lines


def test_ring_kernel_across_two_cards(cuda):
    """4 shards alternating over two cards: each card's one launch reads its
    neighbours' edges over peer access."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    offsets = RING_OFFSETS["penta"]
    op = _op(offsets, 3, 4 * 5000, 25, torch.float64, cuda)
    v = torch.randn((3, 4 * 5000), dtype=torch.float64, device=cuda, generator=torch.Generator(cuda).manual_seed(26))
    devices = [torch.device("cuda", i % 2) for i in range(4)]
    before = _build.launches["ring_spmv"]
    got, sop, _ = _ring_on(devices, op, v)
    assert [g.device for g in got] == devices and _build.launches["ring_spmv"] == before + 2
    on_cpu = make_ring_spmv(make_mesh(devices=[torch.device("cpu")] * 4), offsets)(op.bands.cpu(), v.cpu())
    assert torch.equal(gather(got, sop.mesh).cpu(), on_cpu)


@pytest.mark.parametrize("comm", ["ring", "gspmd"])
def test_solve_sharded_across_cards(cuda, comm):
    """One mode shard per card: the ring route launches once per card and
    step, reading its neighbours' edges over peer access; both routes give
    the unsharded solve's traces."""
    cards = min(torch.cuda.device_count(), 4)
    if cards < 2:
        pytest.skip("needs two CUDA devices")
    op = tkt.laplace(4, 400, shift=2e4, device=cuda)
    b = tkt.random_rhs(4, 400, seed=7, device=cuda)
    cfg = tkt.SolverConfig(kmax=60, tol=1e-8)
    ref = tkt.solve(op, b, cfg)
    _build.launches.clear()
    res = solve_sharded(op, b, cfg, make_mesh(devices=[torch.device("cuda", i) for i in range(cards)]), comm)
    torch.cuda.synchronize()
    k = res.niterations
    # one shard per card: one ring launch, or one banded_spmv launch, per card and step
    assert _build.launches["ring_spmv" if comm == "ring" else "banded_spmv"] == cards * k
    assert (res.status, k) == (ref.status, ref.niterations) and res.status == tkt.Status.CONVERGED
    torch.testing.assert_close(res.relative_residual[1:k + 1], ref.relative_residual[1:k + 1], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 8000), (4, 3, 8000)])
def test_gspmd_route_equals_unsharded_spmv(cuda, shape):
    """Each shard's banded_spmv launch on its halo-extended slab gives the
    unsharded kernel's bits."""
    op = _op(RING_OFFSETS["penta"], 4, 8000, 27, torch.float64, cuda)
    v = torch.randn(shape, dtype=torch.float64, device=cuda, generator=torch.Generator(cuda).manual_seed(28))
    mesh = make_mesh(devices=[cuda] * 4)
    sop = shard_operator(op, mesh)
    before = dict(_build.launches)
    got = gather(spmv_sharded(sop, shard_rhs(v, mesh)), mesh)
    torch.cuda.synchronize()
    assert _build.launches["banded_spmv"] == before.get("banded_spmv", 0) + 4
    assert _build.launches["ring_spmv"] == before.get("ring_spmv", 0)
    assert torch.equal(got, spmv(op, v))


@pytest.mark.parametrize("fp,comm,orth", [(1, "ring", "lanczos_reorth"), (1, "gspmd", "lanczos_reorth"),
                                          (2, "ring", "lanczos_reorth"), (1, "ring", "arnoldi")])
def test_solve_sharded_on_card_goes_through_kernel(cuda, fp, comm, orth):
    """4 shards on the card: every SpMV of the ring route is one ring launch
    and none of banded_spmv; of the gspmd route 4 banded_spmv launches and
    no ring launch; the traces agree with the unsharded solve on the card."""
    op = tkt.laplace(4, 400, shift=2e4, device=cuda)
    b = tkt.random_rhs(4, 400, seed=7, device=cuda)
    cfg = tkt.SolverConfig(kmax=60, tol=1e-8, orth=orth)
    ref = tkt.solve(op, b, cfg)
    _build.launches.clear()
    res = solve_sharded(op, b, cfg, make_mesh(devices=[cuda] * 4, factor_parallel=fp), comm)
    torch.cuda.synchronize()
    k = res.niterations
    kernel, other, per_step = ("ring_spmv", "banded_spmv", 1) if comm == "ring" else ("banded_spmv", "ring_spmv", 4)
    assert _build.launches[kernel] == per_step * k and _build.launches[other] == 0
    assert (res.status, k) == (ref.status, ref.niterations) and res.status == tkt.Status.CONVERGED
    torch.testing.assert_close(res.relative_residual[1:k + 1], ref.relative_residual[1:k + 1], rtol=1e-8, atol=1e-12)
    assert res.x.factors.device == ref.x.factors.device


@pytest.mark.parametrize("kernel", ["fused_lanczos", "ring_spmv"])
def test_kernel_graph_replay_equals_call(cuda, kernel):
    """The fused core and the ring SpMV over 4 shards of the card, captured in
    a CUDA graph (the timer's device-only ms): a replay gives the call's
    bits."""
    op = _op((-1, 0, 1), 4, 8000, 44, torch.float64, cuda)
    g = torch.Generator(cuda).manual_seed(45)
    v, v_pprev, b = (torch.randn((4, 8000), dtype=torch.float64, device=cuda, generator=g) for _ in range(3))
    if kernel == "fused_lanczos":
        beta = torch.rand(4, dtype=torch.float64, device=cuda, generator=g)
        call = lambda: tuple(fused_lanczos_core(op, v, v_pprev, beta, b))
    else:
        mesh = make_mesh(devices=[cuda] * 4)
        sop, vs = shard_operator(op, mesh, "ring"), shard_rhs(v, mesh)
        call = lambda: tuple(spmv_sharded(sop, vs))
    ref = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, r) for a, r in zip(out, ref))


def test_ring_wrapper_rejects_bad_input(cuda):
    op = _op((-1, 0, 1), 2, 64, 4, torch.float64, cuda)
    v = torch.ones((2, 64), dtype=torch.float64, device=cuda)
    halo = torch.zeros((2, 1), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        ring_spmv_local(op, v.float(), halo.float(), halo.float())
    with pytest.raises(ValueError):
        ring_spmv_local(op, v, torch.zeros((2, 2), dtype=torch.float64, device=cuda), halo)
    with pytest.raises(ValueError):
        ring_spmv_local(op, torch.ones((2, 128), dtype=torch.float64, device=cuda)[:, ::2], halo, halo)
    with pytest.raises(ValueError):
        ring_spmv_local(op, v, halo.cpu(), halo)


def _solver_problem(device, R=None, seed=31, sigma=4e4):
    """reaction_diffusion(3, 1001, σ=4e4) made on the CPU and copied, and unit-row b
    (d, n), or B (R, d, n), so that both devices start from the same bits."""
    op = tkt.reaction_diffusion(3, 1001, sigma, device="cpu")  # factor κ ≈ 100
    shape = (3, 1001) if R is None else (R, 3, 1001)
    b = torch.randn(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(seed))
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return tkt.KroneckerSumOperator(op.bands.to(device), op.offsets), b.to(device)


def _traces_close(got, ref, rtol):
    k = ref.niterations
    assert (got.status, got.niterations) == (ref.status, k)
    r, g = ref.relative_residual.cpu().numpy(), got.relative_residual.cpu().numpy()
    idx = np.flatnonzero(np.isfinite(r))
    np.testing.assert_allclose(g[idx], r[idx], rtol=rtol)


def test_solve_block_on_card_equals_cpu(cuda):
    """One banded_spmv launch of the (d, R, n) block per block step; status,
    steps and residual trace as on the CPU (CGS2 keeps the bases within
    rounding of each other)."""
    cfg = tkt.SolverConfig(kmax=60, tol=1e-8, check_every=4)
    ref = tkt.solve_block(*_solver_problem("cpu", R=3), cfg)
    _build.launches.clear()
    got = tkt.solve_block(*_solver_problem(cuda, R=3), cfg)
    torch.cuda.synchronize()
    assert got.status == tkt.Status.CONVERGED and _build.launches["banded_spmv"] == got.niterations
    _traces_close(got, ref, 1e-8)
    np.testing.assert_allclose(got.x.factors.cpu().numpy(), ref.x.factors.numpy(), rtol=0,
                               atol=1e-9 * float(ref.x.factors.abs().max()))


@pytest.mark.parametrize("step_impl,launches", [("fused", {"fused_lanczos": 1, "banded_spmv": 1, "tridiag_eigh": 1}),
                                                ("auto", {"banded_spmv": 2, "tridiag_eigh": 1})])
def test_solve_two_pass_on_card_equals_cpu(cuda, step_impl, launches):
    """Per step: pass 1's fused core and pass 2's SpMV, or one SpMV in each
    pass, and pass 1's check through the tridiagonal eigensolver (the same
    eigh_impl on both devices: its plain version on the CPU); status, steps
    and residual trace as on the CPU (each device's H rounds apart). The
    fused route's pass 1 runs one recurrence on both devices, bit for bit
    (the fused core and the start's sums in a fixed order, sqrt correctly
    rounded)."""
    from tensorkrylov_tpu_torch import twopass
    from tensorkrylov_tpu_torch.coeffs.tables import load_tables

    cfg = tkt.SolverConfig(kmax=60, tol=1e-8, orth="lanczos", step_impl=step_impl, eigh_impl="tridiag_mixed")
    ref = tkt.solve_two_pass(*_solver_problem("cpu"), cfg)
    _build.launches.clear()
    got = tkt.solve_two_pass(*_solver_problem(cuda), cfg)
    torch.cuda.synchronize()
    k = got.niterations
    assert got.status == tkt.Status.CONVERGED
    assert dict(_build.launches) == {kern: n * k for kern, n in launches.items()}
    _traces_close(got, ref, 1e-6)
    if step_impl == "fused":
        H = [twopass._pass1(op, twopass._start(b, torch.float64, torch.float64), load_tables(device=op.device),
                            got.config).H.cpu() for op, b in (_solver_problem(cuda), _solver_problem("cpu"))]
        assert torch.equal(H[0][:, :k + 1, :k + 1], H[1][:, :k + 1, :k + 1])
    np.testing.assert_allclose(got.x.factors.cpu().numpy(), ref.x.factors.numpy(), rtol=0,
                               atol=1e-9 * float(ref.x.factors.abs().max()))


def test_fused_two_pass_h_equals_fused_solve_on_card(cuda):
    """The fused two-pass route records the fused solve's α and β bit for bit
    on the card: the same kernel and the same post-processing."""
    from tensorkrylov_tpu_torch import twopass
    from tensorkrylov_tpu_torch.coeffs.tables import load_tables
    from tensorkrylov_tpu_torch.solver import _segment, _setup

    op, b = _solver_problem(cuda)
    cfg = tkt.SolverConfig(kmax=60, tol=1e-8, orth="lanczos", step_impl="fused")
    p, carry = _setup(op, b, cfg, None)
    c = _segment(p, carry, cfg.kmax)
    p1 = twopass._pass1(op, twopass._start(b, torch.float64, torch.float64), load_tables(device=cuda), p.config)
    assert p1.k == c.k and torch.equal(p1.H, c.H) and torch.equal(p1.history.rel_res, c.rel_res)


@pytest.mark.parametrize("step_impl", ["fused", "auto"])
def test_two_pass_on_card_matches_solve(cuda, step_impl):
    """solve_two_pass against solve with the same config on the card (the
    κ = 1e2 slice at n=8192, plain Lanczos): the same steps; the final
    estimate within 1e-10 relative (the unfused route forms b̃_k = ⟨v_k, b⟩
    where solve forms ub/β, which moves it by up to κ·eps·‖b‖ more), on the
    fused route the same traces bit for bit; x within 1e-8 of max|x|; per
    step pass 1's fused core and pass 2's SpMV, or an SpMV in each pass; a
    peak memory below solve's (no stored basis)."""
    op, b = _rd_problem(cuda, 8192, 1e2)
    cfg = tkt.SolverConfig(kmax=200, tol=1e-8, orth="lanczos", step_impl=step_impl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref = tkt.solve(op, b, cfg)
    torch.cuda.synchronize()
    peak_ref = torch.cuda.max_memory_allocated()
    k, x_ref = ref.niterations, ref.x.factors.cpu()
    traces = {f: getattr(ref, f).cpu() for f in ("relative_residual", "projected_residual", "expsum_rank")}
    del ref
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    tp = tkt.solve_two_pass(op, b, cfg)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() < peak_ref
    assert tp.status == tkt.Status.CONVERGED and tp.niterations == k
    final, ref_final = float(tp.relative_residual[k]), float(traces["relative_residual"][k])
    atol = 0.0 if step_impl == "fused" else 1e2 * float(np.finfo(np.float64).eps)   # unit rows: ‖b‖ = 1
    assert abs(final - ref_final) <= 1e-10 * ref_final + atol
    if step_impl == "fused":
        assert all(torch.equal(getattr(tp, f).cpu(), t) for f, t in traces.items())
    x = tp.x.factors.cpu()
    assert bool(torch.isfinite(x).all()) and float((x - x_ref).abs().max()) <= 1e-8 * float(x_ref.abs().max())
    want = {"fused_lanczos": k, "banded_spmv": k} if step_impl == "fused" else {"fused_lanczos": 0,
                                                                                "banded_spmv": 2 * k}
    assert {kern: _build.launches[kern] for kern in want} == want


def test_solve_refined_on_card(cuda):
    """solve_refined on config 4's operator (n=2048) and b = B[0] on the card:
    the residual history decreasing, at least one kron_apply_cp launch per
    residual besides the inner solves' steps, and its true relative residual
    the device cross-check's within the check's floor and refine.py's
    cancellation floor (1e-8·‖b‖)."""
    from tensorkrylov_tpu_torch.utils.cp import cp_residual_cross_check_device

    op, B = _rd_problem(cuda, 2048, 1e4, R=4)
    b = B[0].contiguous()
    _build.launches.clear()
    res = tkt.solve_refined(op, b, tkt.SolverConfig(kmax=40, tol=1e-8), max_restarts=2, residual_rank=6,
                            inner_tol=1e-4)
    torch.cuda.synchronize()
    h = res.residual_history
    assert len(h) >= 1 and all(a > c for a, c in zip(h, h[1:]))
    assert _build.launches["banded_spmv"] - sum(res.inner_iterations) >= len(h)
    bn = float(torch.prod(torch.linalg.vector_norm(b, dim=1)))
    xc = cp_residual_cross_check_device(op, res.x.weights, res.x.factors, b)
    assert abs(res.true_relative_residual - xc.value / bn) <= (xc.floor + 1e-8 * bn) / bn


def test_kron_apply_cp_on_card_equals_cpu(cuda):
    """One banded_spmv launch of the (d, t, n) columns; the CP result equals
    the CPU's bit for bit (the SpMV kernel's bits equal its plain version's)."""
    from tensorkrylov_tpu_torch.types import CPTensor
    from tensorkrylov_tpu_torch.utils.cp import cp_residual_cross_check_device

    op, _ = _solver_problem("cpu")
    g = torch.Generator().manual_seed(32)
    x = CPTensor(torch.randn(7, dtype=torch.float64, generator=g),
                 torch.randn((3, 1001, 7), dtype=torch.float64, generator=g))
    ref = tkt.kron_apply_cp(op, x)
    opc = tkt.KroneckerSumOperator(op.bands.to(cuda), op.offsets)
    _build.launches.clear()
    got = tkt.kron_apply_cp(opc, CPTensor(x.weights.to(cuda), x.factors.to(cuda)))
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"banded_spmv": 1} and got.rank == 21
    assert torch.equal(got.weights.cpu(), ref.weights) and torch.equal(got.factors.cpu(), ref.factors)
    b = torch.randn((3, 1001), dtype=torch.float64, generator=g)
    chk_cpu = cp_residual_cross_check_device(op, x.weights, x.factors, b)
    chk = cp_residual_cross_check_device(opc, x.weights.to(cuda), x.factors.to(cuda), b.to(cuda))
    np.testing.assert_allclose(chk.value, chk_cpu.value, rtol=1e-10)


def _deflated_problem(device, n=30):
    """tests/test_deflate.py's oracle case, laplace(3, n, shift=50) with
    random_rhs seed 7, made on the CPU and copied."""
    op = tkt.laplace(3, n, shift=50.0, device="cpu")
    return tkt.KroneckerSumOperator(op.bands.to(device), op.offsets), tkt.random_rhs(3, n, seed=7).to(device)


@pytest.mark.parametrize("storage,n", [("full", 30), ("twopass", 40), ("segmented", 40)])
def test_solve_deflated_on_card_equals_cpu(cuda, storage, n):
    """The deflated solve on the card: its status, steps and checkpoints as
    on the CPU, the certified bounds within 1e-9, the dense oracle below the
    bound, x on the card; one banded_spmv launch per step (twopass: pass 1's
    k and pass 2's k - 1) and one for the device cross-check's A·X. The
    storages without reorthogonalization run at n=40, where the deflated
    space (n − m = 34) is not exhausted by the 24 steps: at exhaustion plain
    Lanczos amplifies each device's rounding apart. Both devices take the
    tridiagonal eigensolver (its plain version on the CPU), one launch per
    checkpoint on the card."""
    cfg = tkt.SolverConfig(kmax=32, tol=1e-7, orth="lanczos" if storage == "twopass" else "lanczos_reorth",
                           eigh_impl="tridiag_mixed")
    kw = dict(m=6, checkpoints=[8, 16, 24, 32], storage=storage, segment=8)
    ref = tkt.solve_deflated(*_deflated_problem("cpu", n), cfg, **kw)
    _build.launches.clear()
    op, b = _deflated_problem(cuda, n)
    got = tkt.solve_deflated(op, b, cfg, **kw)
    torch.cuda.synchronize()
    k = got.niterations
    assert (got.status, k, got.checkpoints) == (ref.status, ref.niterations, ref.checkpoints)
    assert got.status == tkt.Status.CONVERGED and got.x.factors.device.type == "cuda"
    # the boundary term's last row of y rounds to eps·‖y‖ absolute (tests/test_torch_deflate.py); plain
    # Lanczos (twopass) amplifies each device's rounding apart, as test_solve_two_pass_on_card_equals_cpu's
    rtol, atol = (1e-6, 0.0) if storage == "twopass" else (1e-9, 1e-15)
    np.testing.assert_allclose(got.certified_bound, ref.certified_bound, rtol=rtol, atol=atol)
    assert tkt.kron_residual_dense(op, got.x, b) <= got.certified_bound[-1] + 1e-14
    steps = 2 * k - 1 if storage == "twopass" else k
    assert dict(_build.launches) == {"banded_spmv": steps + 1, "tridiag_eigh": len(got.checkpoints), "expsum_sup": 1,
                                     "gram_dot2": 1}
    assert got.cp_residual_floor is not None and got.measured_cp_residual is not None
    assert (got.boundary_drift_max is not None) == (storage == "segmented")


def test_deflated_twopass_replays_full_on_card(cuda):
    """orth='lanczos': twopass runs full's step, so T and b̃ are equal bit for
    bit on the card (one recurrence, the same cuBLAS shapes), and pass 2
    repeats pass 1 (its replayed β deviates by at most 1e-14)."""
    from tensorkrylov_tpu_torch import deflate_light
    from tensorkrylov_tpu_torch.ops.orth import deflation_project

    op = tkt.reaction_diffusion(4, 4099, 3e4, device=cuda)
    b = tkt.random_rhs(4, 4099, seed=3).to(cuda)
    U = torch.tensor(tkt.deflation_basis(op, 32).U, device=cuda)
    b_perp = deflation_project(b, U)
    k = 60
    full, light = deflate_light._init_state(b_perp, k + 1), deflate_light._init_state(b_perp, k + 1)
    V = torch.zeros((k + 1, 4, 4099), dtype=torch.float64, device=cuda)
    V[0] = full.vp
    deflate_light._advance(op, full, b_perp, U, 1, k + 1, V=V)
    deflate_light._advance(op, light, b_perp, U, 1, k + 1, measure_leak=True)
    for f in ("dg", "od", "btil"):
        assert torch.equal(getattr(full, f), getattr(light, f)), f
    cfg = tkt.SolverConfig(kmax=k, tol=1e-12, orth="lanczos")
    r_full = tkt.solve_deflated(op, b, cfg, m=32, storage="full", checkpoints=[k])
    r_two = tkt.solve_deflated(op, b, cfg, m=32, storage="twopass", checkpoints=[k])
    assert r_two.certified_bound == r_full.certified_bound
    assert r_two.pass2_beta_rel_dev <= 1e-14
    xf, xt = r_full.x.factors, r_two.x.factors
    assert float((xf - xt).abs().max()) <= 1e-12 * float(xf.abs().max())


def test_deflated_twopass_resume_on_card(cuda, tmp_path):
    """A twopass deflated solve stopped at checkpoint 32 and resumed from its
    state cache equals the uninterrupted one bit for bit (bounds and x); the
    resumed solve launches the SpMV for pass 1's remaining steps, pass 2's
    k − 1 and the cross-check, the tridiagonal eigensolver once per evaluated
    checkpoint and the sup error once."""
    op = tkt.reaction_diffusion(4, 4099, 3e4, device=cuda)
    b = tkt.random_rhs(4, 4099, seed=3).to(cuda)
    basis = tkt.deflation_basis(op, 32)
    cfg = tkt.SolverConfig(kmax=96, tol=1e-10, orth="lanczos")
    ref = tkt.solve_deflated(op, b, cfg, basis=basis, storage="twopass")
    cache = str(tmp_path / "state.npz")
    stopped = tkt.solve_deflated(op, b, cfg, basis=basis, storage="twopass", checkpoints=[16, 32], state_cache=cache)
    assert stopped.niterations == 32
    _build.launches.clear()
    res = tkt.solve_deflated(op, b, cfg, basis=basis, storage="twopass", state_cache=cache)
    torch.cuda.synchronize()
    k = ref.niterations
    assert res.certified_bound == ref.certified_bound and torch.equal(res.x.factors, ref.x.factors)
    assert dict(_build.launches) == {"banded_spmv": (k - 32) + (k - 1) + 1, "tridiag_eigh": len(res.checkpoints),
                                     "expsum_sup": 1, "gram_dot2": 1}


# (d, P, n, signed zeros) of the compensated Gram's card cases: the original log-spaced data; ragged n (1, 2, 3: one
# chunk shorter than a 64-leaf slab; 4097: a last chunk of one leaf); P = 33 over n = 65536 (2 J tiles, 3 I tiles, 64
# chunks); a rank-4 block cross-check's P = 4 + 2t (t = 9); a tree whose every level is even (its -0 products stay -0)
GRAM_CASES = {
    "logspaced": (3, 7, 40001, False), "n1": (3, 7, 1, True), "n2": (3, 7, 2, True), "n3": (3, 7, 3, True),
    "n4097": (3, 7, 4097, True), "P33": (2, 33, 65536, False), "block_R4": (3, 4 + 2 * 9, 3001, False),
    "zeros_n4096": (2, 5, 4096, True),
}


@pytest.mark.parametrize("case", list(GRAM_CASES))
def test_gram_dot2_on_card_equals_cpu(cuda, case):
    """The device cross-check's compensated Gram: the gram_dot2 kernel (one
    call, counted once) sums the plain version's tree, so the card's (hi, lo)
    pairs equal the CPU's bit for bit, signs of zero included; with signed
    zeros, mode 0 has a zero row against a negative one (every product -0)."""
    from tensorkrylov_tpu_torch.utils.cp import _gram_dot2

    d, P, n, zeros = GRAM_CASES[case]
    g = torch.Generator().manual_seed(5)
    C = torch.randn((d, P, n), dtype=torch.float64, generator=g) * torch.logspace(-4, 4, n, dtype=torch.float64)
    if zeros:
        C[0, 0] = 0.0
        C[0, 1] = -C[0, 1].abs()
    hi, lo = _gram_dot2(C)
    before = _build.launches["gram_dot2"]
    hi_c, lo_c = _gram_dot2(C.to(cuda))
    torch.cuda.synchronize()
    assert _build.launches["gram_dot2"] == before + 1
    for got, want in ((hi_c, hi), (lo_c, lo)):
        assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("R", [1, 4])
def test_gram_dot2_one_launch_per_cross_check(cuda, R):
    """cp_residual_cross_check_device on the card launches the Gram kernel
    once and the SpMV once (A·X), and its value and floor are the CPU's bit
    for bit, for a rank-1 b (d, n) and a rank-R block B (R, d, n); a CUDA
    tensor the kernel cannot take raises, with no fallback."""
    from tensorkrylov_tpu_torch.utils.cp import _gram_dot2, cp_residual_cross_check_device

    rng = np.random.default_rng(R)
    op = tkt.reaction_diffusion(3, 2000, 0.5, device="cpu")
    X = torch.tensor(rng.standard_normal((3, 2000, 6)))
    w = torch.tensor(rng.standard_normal(6))
    b = torch.tensor(rng.standard_normal((3, 2000) if R == 1 else (R, 3, 2000)))
    ref = cp_residual_cross_check_device(op, w, X, b)
    op_c = tkt.KroneckerSumOperator(op.bands.to(cuda), op.offsets)
    _build.launches.clear()
    got = cp_residual_cross_check_device(op_c, w.to(cuda), X.to(cuda), b.to(cuda))
    assert dict(_build.launches) == {"banded_spmv": 1, "gram_dot2": 1}
    assert (got.value, got.floor) == (ref.value, ref.floor)
    C = torch.ones((2, 3, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float64"):
        _gram_dot2(C.float())
    with pytest.raises(ValueError, match="contiguous"):
        _gram_dot2(C.transpose(1, 2))


def test_expansion_arithmetic_on_card_equals_cpu(cuda):
    """The error-free transforms on the card: eft_selfcheck's defects are 0,
    and the pair SpMV and a commit chain give the CPU's bits (every step its
    own rounded op, none contracted into an FMA)."""
    from tensorkrylov_tpu_torch.ops import expansion as ex

    chk = ex.eft_selfcheck(device=cuda)
    assert chk["two_sum"] == 0.0 and chk["two_prod"] == 0.0
    op = tkt.reaction_diffusion(3, 4099, 1.0 / 3.0, device="cpu")
    v = torch.randn((3, 4099), dtype=torch.float64, generator=torch.Generator().manual_seed(2))

    def chain(bands, vv):
        z = ex.triple_spmv_pairs(*ex.pair_from_f64(bands), op.offsets, *ex.pair_from_f64(vv))
        z = ex.triple_sub(z, ex.pair_scale_f64(*ex.pair_from_f64(vv), torch.full((3, 1), 0.7, dtype=vv.dtype,
                                                                                   device=vv.device)))
        return ex.triple_round_pair(ex.triple_scale_f64(z, torch.full((3, 1), 1.0 / 3.0, dtype=vv.dtype,
                                                                          device=vv.device)))[0]

    for a, c in zip(chain(op.bands.to(cuda), v.to(cuda)), chain(op.bands, v)):
        assert torch.equal(a.cpu(), c)


def _df64_traced(monkeypatch, op, b, cfg, kw):
    """A traced df64 solve: (result, solve record, whether a read inside
    'deflated.df64_evaluate' touched the storage of the record's W or C)."""
    from tensorkrylov_tpu_torch import df64_core
    from tensorkrylov_tpu_torch.utils import profiling

    states, storages = [], []
    real_init, real_read = deflate._df64_init, profiling.host_read

    def init(*a, **k):
        out = real_init(*a, **k)
        states.append(out[0])
        return out

    def read(x, *a):
        if isinstance(x, torch.Tensor) and profiling._STACK[-1].name.startswith("deflated.df64_evaluate"):
            storages.append(x.untyped_storage().data_ptr())
        return real_read(x, *a)

    monkeypatch.setattr(deflate, "_df64_init", init)
    for module in (deflate, df64_core):
        monkeypatch.setattr(module, "host_read", read)
    with profiling.tracing():
        res = tkt.solve_deflated(op, b, cfg, **kw)
    (st,) = states
    touched = bool({x.untyped_storage().data_ptr() for x in (st.W, st.C)} & set(storages))
    return res, profiling.solve_records()[-1], touched


def test_solve_deflated_df64_on_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """storage='df64', final='device' on the card: status, steps and
    checkpoints as on the CPU, the bounds within 1e-9 (cuBLAS and the CPU
    round the GEMMs apart), one banded_spmv launch (the cross-check's A·X)
    and one of the sup error's kernel, x on the card, the dense oracle below
    the bound; a solve stopped at 8 and resumed from its cache equals the
    uninterrupted one bit for bit, with the same launches. The recorded
    relation is evaluated on the card: a traced solve, bit-equal, opens
    'deflated.df64_evaluate.card' under each evaluation span and reads
    neither W nor C to the host."""
    def problem(device):
        op = tkt.laplace(2, 64, shift=30.0, device=device)
        b = tkt.random_rhs(2, 64, seed=5)
        return op, (b / torch.linalg.vector_norm(b, dim=1, keepdim=True)).to(device)

    cfg = tkt.SolverConfig(kmax=24, tol=1e-12)
    kw = dict(m=6, storage="df64", final="device", checkpoints=[8, 16, 24])
    ref = tkt.solve_deflated(*problem("cpu"), cfg, **kw)
    op, b = problem(cuda)
    _build.launches.clear()
    got = tkt.solve_deflated(op, b, cfg, **kw)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"banded_spmv": 1, "expsum_sup": 1, "gram_dot2": 1}
    assert (got.status, got.niterations, got.checkpoints) == (ref.status, ref.niterations, ref.checkpoints)
    np.testing.assert_allclose(got.certified_bound, ref.certified_bound, rtol=1e-9)
    assert got.x.factors.device.type == cuda.type and got.gram_deviation < 1e-12
    assert tkt.kron_residual_dense(op, got.x, b) <= got.certified_bound[-1]
    cache = str(tmp_path / "state.npz")
    tkt.solve_deflated(op, b, cfg, **{**kw, "checkpoints": [8]}, state_cache=cache)
    _build.launches.clear()
    resumed = tkt.solve_deflated(op, b, cfg, **kw, state_cache=cache)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"banded_spmv": 1, "expsum_sup": 1, "gram_dot2": 1}
    assert resumed.certified_bound == got.certified_bound and torch.equal(resumed.x.factors, got.x.factors)
    traced, rec, touched = _df64_traced(monkeypatch, op, b, cfg, kw)
    assert traced.certified_bound == got.certified_bound and not touched
    cards = [s for s in rec.spans if s.name == "deflated.df64_evaluate.card"]
    assert cards and all(s.parent.name == "deflated.df64_evaluate" and s.device_ms is not None for s in cards)


def test_solve_block_recorded_on_card_equals_cpu(cuda):
    """solve_block_recorded on the card ('auto' is final='device' there):
    status, steps and checkpoints as on the CPU, the bounds within 1e-9 up to
    the relation terms, one banded_spmv launch (the rank-R cross-check's A·X)
    and one sup-error launch per checkpoint (its coefficients follow the Ritz
    λ_min there); certified below tol, the cross-check not contradicting the
    bound."""
    B = np.random.default_rng(1).standard_normal((2, 2, 48))
    cfg = tkt.SolverConfig(kmax=23, tol=1e-8)
    ref = tkt.solve_block_recorded(tkt.laplace(2, 48, shift=2000.0, device="cpu"), B, cfg, m=4)
    _build.launches.clear()
    got = tkt.solve_block_recorded(tkt.laplace(2, 48, shift=2000.0, device=cuda), B, cfg, m=4)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"banded_spmv": 1, "expsum_sup": len(got.checkpoints), "gram_dot2": 1}
    assert got.x.factors.device.type == cuda.type
    assert (got.status, got.niterations, got.checkpoints) == (ref.status, ref.niterations, ref.checkpoints)
    # the relation terms (dev, η, r2 ∝ ρ²) are roundoff records, which cuBLAS and the CPU round apart
    slack = max(r.relation_dev_term + r.relation_eta_term + r.relation_r2_term for r in (got, ref))
    for a, r in zip(got.certified_bound, ref.certified_bound):
        assert abs(a - r) <= 1e-9 * r + slack, (a, r, slack)
    assert got.converged and got.certified_bound[-1] < cfg.tol
    assert "CONTRADICT" not in _verdict(got, cfg.tol)


def _verdict(res, tol):
    """The cross-check's verdict on a certified result's bound."""
    from tensorkrylov_tpu_torch.experiments.northstar import interpret_cross_check

    return interpret_cross_check(res.measured_cp_residual, res.cp_residual_floor, res.certified_bound[-1], tol)


def _small_deflated_problem(device):
    op = tkt.laplace(3, 256, shift=3000.0, device=device)
    b = tkt.random_rhs(3, 256, seed=5)
    return op, (b / torch.linalg.vector_norm(b, dim=1, keepdim=True)).to(device)


# the deflated solves' sizes: the problem, SolverConfig's fields, solve_deflated's. 'mid' is the κ = 1e5 mid shape
# (d=10, n=16384, m=256), 'flagship' the κ = 1e6 cells' solve (d=10, n=131072, m=2048, checkpoints 384/448/512)
DEFLATED_SIZES = {
    "small": (_small_deflated_problem, dict(kmax=48, tol=1e-8), dict(m=8, checkpoints=[16, 32, 48])),
    "mid": (lambda dev: _rd_problem(dev, 16384, 1e5), dict(kmax=384, tol=1e-8), dict(m=256)),
    "flagship": (lambda dev: _rd_problem(dev, 131072, 1e6), dict(kmax=512, tol=1e-8, orth="lanczos_reorth_auto"),
                 dict(m=2048, checkpoints=[384, 448, 512])),
}


def _deflated_size(size, device):
    """DEFLATED_SIZES[size] on device: op, b, the config, and solve_deflated's
    fields with the deflation basis computed once."""
    problem, cfg, kw = DEFLATED_SIZES[size]
    op, b = problem(device)
    return op, b, tkt.SolverConfig(**cfg), dict(kw, basis=tkt.deflation_basis(op, kw["m"]))


def test_sharded_deflated_twopass_ring_on_card(cuda):
    """solve_deflated(storage='twopass', comm='ring') on 4 mode shards of one
    card against the unsharded solve on the card: status, steps and
    checkpoints equal, the bounds within 1e-6 (plain Lanczos: the pieces'
    sums round apart and the recurrence amplifies it, 1e-7 on the CPU), x
    gathered on the card within 1e-10; one ring launch per SpMV of both
    passes (k + k − 1), one banded_spmv launch (the cross-check's A·X), one
    tridiag_eigh launch per checkpoint and one sup-error launch on the lead;
    certified below tol, the cross-check not contradicting the bound."""
    op, b, cfg, kw = _deflated_size("small", cuda)
    kw.update(storage="twopass")
    ref = tkt.solve_deflated(op, b, cfg, **kw)
    _build.launches.clear()
    got = tkt.solve_deflated(op, b, cfg, mesh=make_mesh(devices=[cuda] * 4), comm="ring", **kw)
    torch.cuda.synchronize()
    k = got.niterations
    assert dict(_build.launches) == {"ring_spmv": 2 * k - 1, "banded_spmv": 1, "tridiag_eigh": len(got.checkpoints),
                                     "expsum_sup": 1, "gram_dot2": 1}
    assert (got.status, k, got.checkpoints) == (ref.status, ref.niterations, ref.checkpoints)
    assert got.status == tkt.Status.CONVERGED
    np.testing.assert_allclose(got.certified_bound, ref.certified_bound, rtol=1e-6)
    assert got.certified_bound[-1] < cfg.tol and "CONTRADICT" not in _verdict(got, cfg.tol)
    assert got.x.factors.device.type == cuda.type
    np.testing.assert_allclose(got.x.factors.cpu().numpy(), ref.x.factors.cpu().numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("size", ["small", pytest.param("flagship", marks=pytest.mark.slow)])
def test_sharded_deflated_df64_gspmd_on_card(cuda, size):
    """solve_deflated(storage='df64', final='device') on 4 mode shards of one
    card (comm='gspmd') against the unsharded solve on the card: status and
    steps equal, the bounds within 1e-6 (the recorded relation's terms and
    the interim checkpoints' estimates are roundoff records that the pieces'
    sums and the card's GEMMs move, 3e-8 relative at the flagship), the
    cross-checks within twice the larger floor, one banded_spmv launch (the
    cross-check's: the pair SpMV is expansion arithmetic in torch ops on each
    shard's halo-extended slab) and one sup-error launch on the lead, as
    unsharded; both
    certified below tol on the measured full Gram, their cross-checks not
    contradicting the bound. At the flagship's size too: the certifying
    mode of the κ = 1e6 cells' solve."""
    op, b, cfg, kw = _deflated_size(size, cuda)
    kw.update(storage="df64", final="device")
    _build.launches.clear()
    ref = tkt.solve_deflated(op, b, cfg, **kw)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"banded_spmv": 1, "expsum_sup": 1, "gram_dot2": 1}
    _build.launches.clear()
    got = tkt.solve_deflated(op, b, cfg, mesh=make_mesh(devices=[cuda] * 4), **kw)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"banded_spmv": 1, "expsum_sup": 1, "gram_dot2": 1}
    assert (got.status, got.niterations, got.checkpoints) == (ref.status, ref.niterations, ref.checkpoints)
    assert got.status == tkt.Status.CONVERGED
    np.testing.assert_allclose(got.certified_bound, ref.certified_bound, rtol=1e-6)
    band = 2 * max(got.cp_residual_floor, ref.cp_residual_floor)
    assert abs(got.measured_cp_residual - ref.measured_cp_residual) <= band
    for r in (ref, got):
        assert r.x.factors.device.type == cuda.type and bool(torch.isfinite(r.x.factors).all())
        assert r.gram_source == "measured full Gram" and r.certified_bound[-1] < cfg.tol
        assert "CONTRADICT" not in _verdict(r, cfg.tol)


@pytest.mark.parametrize("size", ["small", pytest.param("mid", marks=pytest.mark.slow)])
def test_sharded_deflated_full_gspmd_on_card(cuda, size):
    """solve_deflated(storage='full') on 4 mode shards of one card on the
    gspmd route against the unsharded solve on the card: status, steps and
    checkpoints equal, the bounds within 1e-9 relative beside 1e-15 (the
    boundary row rounds to eps·‖y‖); 4 banded_spmv launches per step and one
    for the cross-check's A·X, one tridiag_eigh launch per checkpoint and one
    sup-error launch on the lead; the unsharded solve one banded_spmv launch
    per step and one for the cross-check."""
    op, b, cfg, kw = _deflated_size(size, cuda)
    kw.update(storage="full")
    _build.launches.clear()
    ref = tkt.solve_deflated(op, b, cfg, **kw)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"banded_spmv": ref.niterations + 1, "tridiag_eigh": len(ref.checkpoints),
                                     "expsum_sup": 1, "gram_dot2": 1}
    _build.launches.clear()
    got = tkt.solve_deflated(op, b, cfg, mesh=make_mesh(devices=[cuda] * 4), comm="gspmd", **kw)
    torch.cuda.synchronize()
    k = got.niterations
    assert dict(_build.launches) == {"banded_spmv": 4 * k + 1, "tridiag_eigh": len(got.checkpoints), "expsum_sup": 1,
                                     "gram_dot2": 1}
    assert (got.status, k, got.checkpoints) == (ref.status, ref.niterations, ref.checkpoints)
    np.testing.assert_allclose(got.certified_bound, ref.certified_bound, rtol=1e-9, atol=1e-15)


@pytest.mark.slow
def test_flagship_deflated_full_on_card(cuda):
    """The κ = 1e6 cells' solve (d=10, n=131072, m=2048) on storage='full':
    converged and certified below tol, the cross-check not contradicting the
    bound, at the dense eigh's status and step; one banded_spmv launch per
    step and one for the cross-check, one tridiag_eigh launch per checkpoint
    and one sup-error launch; x finite on the card."""
    op, b, cfg, kw = _deflated_size("flagship", cuda)
    dense = tkt.solve_deflated(op, b, dataclasses.replace(cfg, eigh_impl="dense"), storage="full", **kw)
    _build.launches.clear()
    res = tkt.solve_deflated(op, b, cfg, storage="full", **kw)
    torch.cuda.synchronize()
    k = res.niterations
    assert res.status == tkt.Status.CONVERGED and res.certified_bound[-1] < cfg.tol
    assert "CONTRADICT" not in _verdict(res, cfg.tol)
    assert (res.status, k) == (dense.status, dense.niterations)
    assert dict(_build.launches) == {"banded_spmv": k + 1, "tridiag_eigh": len(res.checkpoints), "expsum_sup": 1,
                                     "gram_dot2": 1}
    x = res.x.factors
    assert tuple(x.shape[:2]) == (10, 131072) and x.device.type == cuda.type and bool(torch.isfinite(x).all())


@pytest.mark.slow
def test_mid_shape_deflated_storages_on_card(cuda, tmp_path):
    """The κ = 1e5 mid shape (d=10, n=16384, m=256, kmax 384). Plain Lanczos:
    'twopass' at 'full''s status and step with T and b̃ of the two storages'
    shared step equal bit for bit, the same bounds and estimates, x within
    1e-12 of max|x|, one banded_spmv launch per step (twopass: 2k − 1) and
    one for the cross-check; 'segmented' (segment 32) with its drift
    recorded and a finite bound; 'twopass' stopped at checkpoint 64 and
    resumed from its state cache equal to the uninterrupted one bit for bit.
    'df64' (final='device') certified below tol, and a df64 solve stopped at
    checkpoint 64 and resumed from its cache equal to it bit for bit, each
    run one banded_spmv launch and one sup-error launch."""
    from tensorkrylov_tpu_torch import deflate_light
    from tensorkrylov_tpu_torch.ops.orth import deflation_project

    op, b, cfg, kw = _deflated_size("mid", cuda)
    plain = dataclasses.replace(cfg, orth="lanczos")

    def run(config, **fields):
        _build.launches.clear()
        res = tkt.solve_deflated(op, b, config, **kw, **fields)
        torch.cuda.synchronize()
        return res, dict(_build.launches)

    def launches(res, spmvs):
        return {"banded_spmv": spmvs + 1, "tridiag_eigh": len(res.checkpoints), "expsum_sup": 1, "gram_dot2": 1}

    (rf, cf), (rt, ct) = run(plain, storage="full"), run(plain, storage="twopass")
    k = rf.niterations
    assert (rt.status, rt.niterations) == (rf.status, k)
    assert rt.certified_bound == rf.certified_bound and rt.relative_residual == rf.relative_residual
    assert float((rt.x.factors - rf.x.factors).abs().max()) <= 1e-12 * float(rf.x.factors.abs().max())
    assert cf == launches(rf, k) and ct == launches(rt, 2 * k - 1)
    U = torch.tensor(kw["basis"].U, device=cuda)
    b_perp = deflation_project(b, U)
    full, light = deflate_light._init_state(b_perp, k + 1), deflate_light._init_state(b_perp, k + 1)
    V = torch.zeros((k + 1, 10, 16384), dtype=torch.float64, device=cuda)
    V[0] = full.vp
    deflate_light._advance(op, full, b_perp, U, 1, k + 1, V=V)
    deflate_light._advance(op, light, b_perp, U, 1, k + 1, measure_leak=True)
    assert all(torch.equal(getattr(full, f), getattr(light, f)) for f in ("dg", "od", "btil"))
    del U, b_perp, V, full, light
    seg, cs = run(cfg, storage="segmented", segment=32)
    assert seg.boundary_drift_max is not None and np.isfinite(seg.certified_bound[-1])
    assert cs == launches(seg, seg.niterations)
    cache = str(tmp_path / "twopass.npz")
    run(plain, storage="twopass", checkpoints=[32, 64], state_cache=cache)
    res, counts = run(plain, storage="twopass", state_cache=cache)
    assert res.certified_bound == rt.certified_bound and torch.equal(res.x.factors, rt.x.factors)
    assert counts == launches(res, (k - 64) + (k - 1))
    del rf, rt, res
    df64 = dict(storage="df64", final="device", checkpoints=[64, 128, 256, 384])
    ref, c_ref = run(cfg, **df64)
    assert ref.status == tkt.Status.CONVERGED and ref.certified_bound[-1] < cfg.tol
    cache = str(tmp_path / "df64.npz")
    _, c_stop = run(cfg, **{**df64, "checkpoints": [64]}, state_cache=cache)
    res, c_res = run(cfg, **df64, state_cache=cache)
    assert res.certified_bound == ref.certified_bound and res.relative_residual == ref.relative_residual
    assert torch.equal(res.x.factors, ref.x.factors) and torch.equal(res.x.weights, ref.x.weights)
    assert c_ref == c_stop == c_res == {"banded_spmv": 1, "expsum_sup": 1, "gram_dot2": 1}


def test_example_03_on_card(cuda):
    """examples/03_sharded_torch.py on 4 slots of the card: solve_sharded on
    the 2 × 2 mesh (gspmd, one banded_spmv launch per shard and step) and
    the deflated twopass on the ring route (one ring launch per SpMV of both
    passes, the cross-check's A·X, the sup error), the tridiagonal
    eigensolver at each check of both; finite answers, the deflated solve
    converged."""
    import contextlib
    import io
    import os
    import runpy

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    main = runpy.run_path(os.path.join(repo, "examples", "03_sharded_torch.py"), run_name="example")["main"]
    _build.launches.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        rs, rd = main([])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(rs.x.factors).all()) and bool(torch.isfinite(rd.x.factors).all())
    assert rd.status == tkt.Status.CONVERGED
    ks, kd = rs.niterations, rd.niterations
    assert dict(_build.launches) == {"banded_spmv": 4 * ks + 1, "ring_spmv": 2 * kd - 1,
                                     "tridiag_eigh": len(_checked(rs)) + len(rd.checkpoints), "expsum_sup": 1,
                                     "gram_dot2": 1}


def test_nonsym_scale_on_card(cuda, tmp_path):
    """The nonsymmetric runner (experiments/nonsym_scale.py) on the card at
    d=3, n=256, κ = 1e2: converged, its cross-check finite; one banded_spmv
    launch per Arnoldi step and the device cross-check's A·X, one hess_eig
    launch per check."""
    import contextlib
    import io

    from tensorkrylov_tpu_torch.experiments import nonsym_scale

    argv = ["--d", "3", "--n", "256", "--kappa", "1e2", "--kmax", "128", "--tmax", "401", "--check-every", "8",
            "--out", str(tmp_path / "nonsym.json")]
    _build.launches.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        art = nonsym_scale.main(argv)
    torch.cuda.synchronize()
    r = art["result"]
    assert r["converged"] and np.isfinite(r["relative_residual"]) and np.isfinite(r["measured_cp_residual"])
    checks = sum(1 for k in range(1, r["niterations"] + 1) if k % 8 == 0 or k >= 128)
    assert dict(_build.launches) == {"banded_spmv": r["niterations"] + 1, "hess_eig": checks, "gram_dot2": 1}


def _sigma_for_kappa(n, kappa):
    """The diagonal shift that gives a Laplacian factor the condition number κ."""
    lmax = 4.0 * (n + 1) ** 2 * np.sin(n * np.pi / (2 * (n + 1))) ** 2
    lmin = 4.0 * (n + 1) ** 2 * np.sin(np.pi / (2 * (n + 1))) ** 2
    return float((lmax - kappa * lmin) / (kappa - 1.0))


def _rd_problem(device, n, kappa, R=None):
    """reaction_diffusion(10, n, σ for κ), made on the CPU and copied, with a
    unit-row b from random_rhs seed 1234 (the κ = 1e2 slice, the κ = 1e5 mid
    shape, the κ = 1e6 flagship) or, given R, a unit-row B (R, 10, n) from
    numpy's seed 1234 (config 4: R = 4, κ = 1e4)."""
    op = tkt.reaction_diffusion(10, n, _sigma_for_kappa(n, kappa), device="cpu")
    if R is None:
        b = tkt.random_rhs(10, n, seed=1234)
        b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    else:
        b = np.random.default_rng(1234).standard_normal((R, 10, n))
        b = torch.tensor(b / np.linalg.norm(b, axis=2, keepdims=True))
    return tkt.KroneckerSumOperator(op.bands.to(device), op.offsets), b.to(device)


def _sharded_block(cuda, comm):
    """solve_block over 4 mode shards of one card, config 4 at n=2048,
    against the unsharded solve: its status and steps, the estimates within
    1e-8 relative (beside 1e-12), x on the card; returns the steps and the
    launches."""
    op, B = _rd_problem(cuda, 2048, 1e4, R=4)
    cfg = tkt.SolverConfig(kmax=48, tol=1e-8, check_every=8, orth="lanczos_reorth")
    ref = tkt.solve_block(op, B, cfg)
    sop = shard_operator(op, make_mesh(devices=[cuda] * 4), comm)
    _build.launches.clear()
    got = tkt.solve_block(sop, shard_rhs(B, sop.mesh, 10), cfg)
    torch.cuda.synchronize()
    k = got.niterations
    assert (got.status, k) == (ref.status, ref.niterations) and got.status != tkt.Status.BREAKDOWN
    for f in ("relative_residual", "lambda_min", "lambda_max"):
        a, r = getattr(got, f).cpu().numpy(), getattr(ref, f).cpu().numpy()
        ok = np.isfinite(r) & (r != 0)
        np.testing.assert_allclose(a[ok], r[ok], rtol=1e-8, atol=1e-12, err_msg=f)
    assert tuple(got.x.factors.shape) == (10, 2048, cfg.tmax * 4)
    assert got.x.factors.device.type == "cuda" and bool(torch.isfinite(got.x.factors).all())
    return k, dict(_build.launches)


def test_sharded_block_ring_on_card(cuda):
    """The ring route: one ring launch per block step (the (d, 4, n_local)
    block of every shard in one launch), no banded_spmv launch."""
    k, launches = _sharded_block(cuda, "ring")
    assert launches == {"ring_spmv": k}


def test_sharded_block_gspmd_on_card(cuda):
    """The gspmd route: 4 banded_spmv launches per block step (one per
    shard's halo-extended slab), no ring launch."""
    k, launches = _sharded_block(cuda, "gspmd")
    assert launches == {"banded_spmv": 4 * k}


@pytest.mark.slow
def test_config4_block_and_recorded_on_card(cuda):
    """Config 4 at its widths (d=10, n=10240, a rank-4 B, κ = 1e4 a factor):
    solve_block (kmax 96, check every 8, CGS2, spectral source H) without
    breakdown, its traces and x finite, one banded_spmv launch per block step
    and one for the device cross-check; solve_block_recorded (m=512, kmax
    360) converged and certified below tol, the cross-check not
    contradicting the bound, one banded_spmv launch and one sup-error launch
    per checkpoint."""
    from tensorkrylov_tpu_torch.utils.cp import cp_residual_cross_check_device

    n = 10240
    op, B = _rd_problem(cuda, n, 1e4, R=4)
    cfg = tkt.SolverConfig(kmax=96, tol=1e-8, check_every=8, orth="lanczos_reorth", spectral_source="H")
    _build.launches.clear()
    res = tkt.solve_block(op, B, cfg)
    torch.cuda.synchronize()
    assert res.status != tkt.Status.BREAKDOWN and _build.launches["banded_spmv"] == res.niterations
    idx = _checked(res)
    for f in ("relative_residual", "lambda_min", "lambda_max"):
        assert np.isfinite(getattr(res, f).cpu().numpy()[idx]).all(), f
    assert bool(torch.isfinite(res.x.factors).all())
    _build.launches.clear()
    cp_residual_cross_check_device(op, res.x.weights, res.x.factors, B)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"banded_spmv": 1, "gram_dot2": 1}
    del res
    lam_min = 10 * (_sigma_for_kappa(n, 1e4) + 4.0 * (n + 1) ** 2 * np.sin(np.pi / (2 * (n + 1))) ** 2)
    rcfg = tkt.SolverConfig(kmax=360, tol=1e-8)
    basis = tkt.deflation_basis(op, 512)
    _build.launches.clear()
    res = tkt.solve_block_recorded(op, B, rcfg, lam_min=lam_min, basis=basis, final="device")
    torch.cuda.synchronize()
    assert res.converged and res.certified_bound[-1] < rcfg.tol
    assert "CONTRADICT" not in _verdict(res, rcfg.tol)
    assert dict(_build.launches) == {"banded_spmv": 1, "expsum_sup": len(res.checkpoints), "gram_dot2": 1}


def _sharded_two_pass(cuda, comm):
    """solve_two_pass over 4 mode shards of one card, the slice's problem at
    n=8192, against the unsharded solve_two_pass: its status, steps within
    one, x within 1e-6 of max|x|, the final estimate within 1e-6 relative
    beside the v_0 drift's allowance d·√k·(drift of both runs) (b̃_k = ⟨v_k, b⟩
    carries the plain recurrence's drift, its orthogonality trace, which
    another sum order redraws), λ_min and λ_max within 1e-8 (from H alone);
    returns the steps and the launches."""
    op, b = _rd_problem(cuda, 8192, 1e2)
    cfg = tkt.SolverConfig(kmax=200, tol=1e-8, orth="lanczos")
    ref = tkt.solve_two_pass(op, b, cfg)
    sop = shard_operator(op, make_mesh(devices=[cuda] * 4), comm)
    _build.launches.clear()
    got = tkt.solve_two_pass(sop, shard_rhs(b, sop.mesh), cfg)
    torch.cuda.synchronize()
    k, kr = got.niterations, ref.niterations
    assert got.status == ref.status == tkt.Status.CONVERGED and abs(k - kr) <= 1
    drift = float(got.orthogonality[1:k + 1].max()) + float(ref.orthogonality[1:kr + 1].max())
    est, est_ref = float(got.relative_residual[k]), float(ref.relative_residual[kr])
    assert abs(est - est_ref) <= 1e-6 * est_ref + 10 * np.sqrt(max(k, kr)) * drift
    x, xr = got.x.factors, ref.x.factors
    assert x.device.type == "cuda" and float((x - xr).abs().max()) <= 1e-6 * float(xr.abs().max())
    m = min(k, kr) + 1
    for f in ("lambda_min", "lambda_max"):
        a, r = getattr(got, f)[:m].cpu().numpy(), getattr(ref, f)[:m].cpu().numpy()
        ok = np.isfinite(r) & (r != 0)
        np.testing.assert_allclose(a[ok], r[ok], rtol=1e-8, err_msg=f)
    return k, dict(_build.launches)


def test_sharded_two_pass_gspmd_on_card(cuda):
    """The gspmd route: 4 banded_spmv launches per SpMV of both passes
    (4 · 2k), one tridiag_eigh launch per check of pass 1 (k), no ring
    launch."""
    k, launches = _sharded_two_pass(cuda, "gspmd")
    assert launches == {"banded_spmv": 4 * 2 * k, "tridiag_eigh": k}


def test_sharded_two_pass_ring_on_card(cuda):
    """The ring route: one ring launch per SpMV of both passes (2k), one
    tridiag_eigh launch per check of pass 1 (k), no banded_spmv launch."""
    k, launches = _sharded_two_pass(cuda, "ring")
    assert launches == {"ring_spmv": 2 * k, "tridiag_eigh": k}


def test_sharded_multi_rhs_on_card(cuda):
    """solve_multi_rhs, R = 2, on a (rhs=2, factor=1, mode=2) mesh of 4 slots
    of one card against the unsharded lanes: status of shape (2,), each lane's
    status, steps and traces (within 1e-8 beside 1e-12); each lane over its
    group's 2 mode shards on the gspmd route, 2 banded_spmv launches per step
    and one tridiag_eigh launch per check."""
    op, b = _rd_problem(cuda, 4096, 1e2)
    b2 = tkt.random_rhs(10, 4096, seed=1235)
    B = torch.stack([b, (b2 / torch.linalg.vector_norm(b2, dim=1, keepdim=True)).to(cuda)])
    cfg = tkt.SolverConfig(kmax=200, tol=1e-8)
    ref = tkt.solve_multi_rhs(op, B, cfg).results
    mesh = make_mesh(devices=[cuda] * 4, rhs_parallel=2, factor_parallel=1)
    _build.launches.clear()
    mr = tkt.solve_multi_rhs(op, B, cfg, mesh=mesh)
    torch.cuda.synchronize()
    res, ks = mr.results, mr.results.niterations.tolist()
    assert mr.converged and tuple(res.status.shape) == (2,)
    assert res.status.tolist() == ref.status.tolist() and ks == ref.niterations.tolist()
    for f in ("relative_residual", "lambda_min", "lambda_max"):
        a, r = getattr(res, f).cpu().numpy(), getattr(ref, f).cpu().numpy()
        ok = np.isfinite(r) & (r != 0)
        np.testing.assert_allclose(a[ok], r[ok], rtol=1e-8, atol=1e-12, err_msg=f)
    assert tuple(mr.x.factors.shape) == (10, 4096, 2 * cfg.tmax) and bool(torch.isfinite(mr.x.factors).all())
    assert dict(_build.launches) == {"banded_spmv": 2 * sum(ks), "tridiag_eigh": sum(ks)}


def test_dryrun_multichip_on_card(cuda):
    """Every call of the JAX package's multi-chip dry run at its own sizes on
    8 slots of one card, a (2, 4) and a (2, 2, 2) mesh, each held to what the
    dry run asserts; both SpMV kernels run."""
    from tensorkrylov_tpu_torch.experiments import dryrun_multichip

    _build.launches.clear()
    dryrun_multichip.run([cuda] * 8)
    torch.cuda.synchronize()
    assert _build.launches["banded_spmv"] > 0 and _build.launches["ring_spmv"] > 0


def _tridiag_blocks(diag, off):
    return np.stack([np.diag(a) + np.diag(b, 1) + np.diag(b, -1) for a, b in zip(diag, off)])


def _ghost_lanczos_T():
    """60 plain Lanczos steps on a diagonal operator with outliers 4, 6, 10
    above [1, 2]: the outliers come back as ghost copies 1e-15 apart."""
    from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_step

    n, K = 200, 61
    lam = np.concatenate([np.linspace(1.0, 2.0, n - 3), [4.0, 6.0, 10.0]])
    op = tkt.KroneckerSumOperator(torch.tensor(lam[None, None, :]), (0,))
    b = torch.tensor(np.random.default_rng(3).standard_normal((1, n)))
    st, _ = init_state(op, b, K - 1, torch.float64)
    for k in range(1, K):
        st, _ = lanczos_step(op, st, b, k, reorth=False, proj_dtype=torch.float64)
    return st.H.numpy()[:, :K - 1, :K - 1]


def _tridiag_case(case, K):
    """(H (d, K, K), k) of tests/test_torch_tridiag_eigh.py's kinds, the
    padded block filled with symmetric junk the kernel must ignore."""
    rng = np.random.default_rng(K)
    if case.startswith("random_"):
        k = {"random_k1": 1, "random_half": K // 2, "random_K": K}[case]
        T = _tridiag_blocks(rng.standard_normal((3, k)), rng.standard_normal((3, k - 1)))
    elif case == "d1":
        k = K - 3
        T = _tridiag_blocks(rng.standard_normal((1, k)), rng.standard_normal((1, k - 1)))
    elif case == "zero_subdiagonal":
        k = K - 2
        diag, off = rng.standard_normal((2, k)), rng.standard_normal((2, k - 1))
        off[0, k // 3] = off[1, k // 3] = off[1, 2 * k // 3] = 0.0
        T = _tridiag_blocks(diag, off)
    elif case == "wilkinson21":
        k = 21
        T = _tridiag_blocks(np.abs(10.0 - np.arange(21.0))[None], np.ones((1, 20)))
    elif case == "repeated_blocks":
        block = np.diag([2.0, 1.0, 3.0]) + np.diag([0.5, 0.5], 1) + np.diag([0.5, 0.5], -1)
        k = 3 * (K // 3 - 1)
        T = np.kron(np.eye(k // 3), block)[None]
    elif case == "lanczos_ghosts":
        T = _ghost_lanczos_T()
        k = T.shape[1]
    elif case == "flagship_k384":
        k = 384
        T = _tridiag_blocks(2.0 + 0.1 * rng.standard_normal((1, k)), -np.ones((1, k - 1)))
    d = T.shape[0]
    junk = rng.standard_normal((d, K, K))
    H = junk + np.swapaxes(junk, 1, 2)
    H[:, :k, :] = 0.0
    H[:, :, :k] = 0.0
    H[:, :k, :k] = T
    return H, k


TRIDIAG_CASES = {
    31: ("random_k1", "random_half", "random_K", "d1", "zero_subdiagonal", "wilkinson21", "repeated_blocks"),
    201: ("random_k1", "random_half", "random_K", "d1", "zero_subdiagonal", "wilkinson21", "lanczos_ghosts"),
    513: ("random_half", "zero_subdiagonal", "lanczos_ghosts", "flagship_k384"),
}


@pytest.mark.parametrize("K,case", [(K, c) for K, cases in TRIDIAG_CASES.items() for c in cases])
def test_tridiag_kernel_equals_plain(cuda, K, case):
    """The kernel's w and Q (before Newton–Schulz) equal its plain version's
    on the card and on the CPU bit for bit, in f64 with two inverse-iteration
    solves; one launch per call; Q within 1e-13 of orthonormal after
    Newton–Schulz."""
    from tensorkrylov_tpu_torch.ops.eigen import masked_eigh_tridiag_mixed, masked_eigh_tridiag_reference, tridiag_eigh

    H, k = _tridiag_case(case, K)
    Hc = torch.tensor(H, device=cuda)
    before = _build.launches["tridiag_eigh"]
    got = tridiag_eigh(Hc, k)
    torch.cuda.synchronize()
    assert _build.launches["tridiag_eigh"] == before + 1
    ref = masked_eigh_tridiag_reference(Hc, k)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    on_cpu = masked_eigh_tridiag_reference(torch.tensor(H), k)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, on_cpu))
    _, Q = masked_eigh_tridiag_mixed(Hc, k)        # and Newton–Schulz after it: Q orthonormal
    assert float((Q.transpose(1, 2) @ Q - torch.eye(K, dtype=Q.dtype, device=cuda)).abs().max()) <= 1e-13


@pytest.mark.parametrize("K,cases", [(31, ("random_half", "wilkinson21", "repeated_blocks")),
                                     (201, ("random_half", "wilkinson21", "lanczos_ghosts")),
                                     (513, ("zero_subdiagonal", "flagship_k384"))])
@pytest.mark.parametrize("dtype,refine", [(torch.float64, False), (torch.float32, True), (torch.float32, False)])
def test_tridiag_kernel_dtypes_and_one_solve(cuda, dtype, refine, K, cases):
    """f32 (proj_dtype=float32) and one inverse-iteration solve (a basis
    below f64): equal to the plain version bit for bit, one launch a call."""
    from tensorkrylov_tpu_torch.ops.eigen import masked_eigh_tridiag_reference, tridiag_eigh

    for case in cases:
        H, k = _tridiag_case(case, K)
        Hc = torch.tensor(H, dtype=dtype, device=cuda)
        before = _build.launches["tridiag_eigh"]
        got = tridiag_eigh(Hc, k, refine)
        assert _build.launches["tridiag_eigh"] == before + 1
        ref = masked_eigh_tridiag_reference(Hc, k, refine)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), case


def straddling_T(k, split, seed=0):
    """(1, k, k): two decoupled random tridiagonal blocks of sizes split and
    k − split, the second shifted so that its lowest eigenvalue sits 1e-9·‖T‖
    above the first's highest: eigenvalues split − 1 and split form a cluster
    (gap within TRIDIAG_CLUSTER_RTOL·‖T‖) and no other pair does."""
    rng = np.random.default_rng(seed)
    A = _tridiag_blocks(rng.standard_normal((1, split)), rng.standard_normal((1, split - 1)))[0]
    B = _tridiag_blocks(rng.standard_normal((1, k - split)), rng.standard_normal((1, k - split - 1)))[0]
    top, bottom = np.linalg.eigvalsh(A)[-1], np.linalg.eigvalsh(B)[0]
    B += (top - bottom + 1e-9 * 8.0) * np.eye(k - split)
    T = np.zeros((1, k, k))
    T[0, :split, :split], T[0, split:, split:] = A, B
    return T


def _padded_cuda(T, K, cuda):
    d, k, _ = T.shape
    H = np.zeros((d, K, K))
    H[:, :k, :k] = T
    H[:, k:, k:] = np.eye(K - k)
    return torch.tensor(H, device=cuda)


@pytest.mark.parametrize("G", [None, 2, 3, 4, 8, 16])
def test_tridiag_cluster_straddling_two_blocks(cuda, G):
    """A cluster of two near-equal eigenvalues split between blocks r and
    r + 1 of the factor's cluster (its first member's thread reads the
    second's column, which another SM wrote): bit for bit against the plain
    version, at the plan's G and at forced ones (d=1, K=201, k=29)."""
    from tensorkrylov_tpu_torch.ops import eigen

    k, K = 29, 201
    G_run = G if G is not None else eigen.tridiag_cluster(1, k, eigen.tridiag_lanes(1, k), torch.float64, cuda)
    per_block = -(-k // G_run)
    split = per_block if per_block < k else k // 2
    Hc = _padded_cuda(straddling_T(k, split, seed=G_run), K, cuda)
    stats = {}
    ref = eigen.masked_eigh_tridiag_reference(Hc, k, stats=stats)
    assert stats["mgs_members"] == stats["solves"]  # the one two-member cluster
    got = eigen._tridiag_eigh_cuda(Hc, k, True, cluster=G)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("d,k,K", [(1, 1, 1), (1, 1, 31), (4, 1, 9), (1, 29, 201), (10, 29, 201), (10, 27, 31)])
def test_tridiag_small_and_ragged(cuda, d, k, K):
    """d=1 (identical factors), k=1, and k that is not a multiple of the
    eigenvalues per block at every G: bit for bit against the plain version."""
    from tensorkrylov_tpu_torch.ops import eigen

    rng = np.random.default_rng(d * 1000 + k)
    Hc = _padded_cuda(_tridiag_blocks(rng.standard_normal((d, k)), rng.standard_normal((d, k - 1))), K, cuda)
    ref = eigen.masked_eigh_tridiag_reference(Hc, k)
    for G in (None, 1, 2, 4, 5, 8, 16):
        got = eigen._tridiag_eigh_cuda(Hc, k, True, cluster=G)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), G


@pytest.mark.parametrize("lanes", [2, 4, 8, 16, 32])
def test_tridiag_forced_lanes_equal_plain(cuda, lanes):
    """Any P: the kernel's probes and selection are the plain version's (the
    ghost-laden Lanczos T, whose counts are least regular)."""
    from tensorkrylov_tpu_torch.ops import eigen

    H, k = _tridiag_case("lanczos_ghosts", 201)
    Hc = torch.tensor(H, device=cuda)
    got = eigen._tridiag_eigh_cuda(Hc, k, True, lanes=lanes)
    ref = eigen.masked_eigh_tridiag_reference(Hc, k, lanes=lanes)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_tridiag_wrapper_rejects_bad_input(cuda):
    from tensorkrylov_tpu_torch.ops.eigen import tridiag_eigh

    H = torch.zeros((2, 8, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        tridiag_eigh(H.to(torch.int64), 4)
    with pytest.raises(ValueError):
        tridiag_eigh(H, 0)
    with pytest.raises(ValueError):
        tridiag_eigh(H, 9)
    with pytest.raises(ValueError):
        tridiag_eigh(torch.zeros((2, 8, 7), dtype=torch.float64, device=cuda), 4)


def test_default_solve_on_card_takes_the_tridiagonal_kernel(cuda, monkeypatch):
    """'auto' resolves to 'tridiag_mixed' on the card: one tridiag_eigh launch
    per check and no dense eigh of H; the dense oracle below 1e-8, the dense
    run's trace within 1e-7 and its λ traces within 1e-12; the dense run
    launches no tridiag_eigh."""
    from tensorkrylov_tpu_torch import solver

    op = tkt.laplace(3, 30, device=cuda)
    b = tkt.random_rhs(3, 30, seed=7, device=cuda)
    _build.launches.clear()
    dense = tkt.solve(op, b, tkt.SolverConfig(kmax=30, tol=1e-8, eigh_impl="dense"))
    torch.cuda.synchronize()
    assert _build.launches["tridiag_eigh"] == 0
    calls = []
    monkeypatch.setattr(solver, "masked_eigh", lambda *a: calls.append(a) or torch.linalg.eigh(a[0]))
    for check_every in (1, 4):
        _build.launches.clear()
        res = tkt.solve(op, b, tkt.SolverConfig(kmax=30, tol=1e-8, check_every=check_every))
        torch.cuda.synchronize()
        assert res.config.eigh_impl == "tridiag_mixed" and res.status == tkt.Status.CONVERGED
        assert _build.launches["tridiag_eigh"] == -(-res.niterations // check_every)
        assert not calls
        assert tkt.kron_residual_dense(op, res.x, b) <= 1e-8
    res = tkt.solve(op, b, tkt.SolverConfig(kmax=30, tol=1e-8))
    _traces_close(res, dense, 1e-7)
    k = res.niterations
    for f in ("lambda_min", "lambda_max"):
        np.testing.assert_allclose(getattr(res, f)[1:k + 1].cpu().numpy(), getattr(dense, f)[1:k + 1].cpu().numpy(),
                                   rtol=1e-12, err_msg=f)


def test_default_deflated_on_card_takes_the_tridiagonal_kernel(cuda):
    """solve_deflated's checkpoint algebra on the card: one tridiag_eigh launch
    per checkpoint, the bounds within 1e-9 of the dense run's."""
    op, b = _deflated_problem(cuda)
    kw = dict(m=6, checkpoints=[8, 16, 24])
    dense = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=30, tol=1e-7, eigh_impl="dense"), **kw)
    _build.launches.clear()
    got = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=30, tol=1e-7), **kw)
    torch.cuda.synchronize()
    assert _build.launches["tridiag_eigh"] == len(got.checkpoints)
    assert (got.status, got.checkpoints) == (dense.status, dense.checkpoints)
    np.testing.assert_allclose(got.certified_bound, dense.certified_bound, rtol=1e-9)


# (κ, coefficient tolerance) rows of tests/test_torch_expsum_sup.py: a κ = 1e2 solve's, a plain tol, the
# deflated cells' 0.5·tol/κ at the flagship's κ ≈ 1.05e6 and around it
SUP_ROWS = [(1e2, 1e-8 / 1e2), (1e3, 1e-10), (1e6, 0.5e-8 / 1e6), (1.05e6, 0.5e-8 / 1.05e6), (1e7, 0.5e-8 / 1e7)]


def _sup_row(kappa, tol):
    return select_bh(torch.tensor(kappa, dtype=torch.float64), tol, load_tables())


def _sup_plain(co, kappa, n_grid, device):
    """The plain version's maximum on `device`."""
    om, al = expsum._terms(co.omega, co.alpha)
    return float(expsum._sup_residuals(om, al, expsum._grid_step(kappa, n_grid), n_grid, device).max())


@pytest.mark.parametrize("kappa,tol", SUP_ROWS)
def test_expsum_sup_kernel_equals_plain(cuda, kappa, tol):
    """The full 200 000-point grid: one launch, the plain version's bits on
    the card (every product and sum rounded on its own, TwoProduct exact
    either way), within 1e-17 of the host longdouble function; a second
    launch repeats (a maximum does not depend on the atomics' order)."""
    co = _sup_row(kappa, tol)
    before = _build.launches["expsum_sup"]
    got = expsum.expsum_sup_error_dd(co.omega, co.alpha, kappa, device=cuda)
    assert _build.launches["expsum_sup"] == before + 1
    assert got == _sup_plain(co, kappa, expsum.N_GRID, cuda)
    assert abs(got - deflate.expsum_sup_error(co.omega, co.alpha, kappa)) <= 1e-17
    assert expsum.expsum_sup_error_dd(co.omega, co.alpha, kappa, device=cuda) == got


@pytest.mark.parametrize("n_grid", [1, 255, 257, 4001, 200_001])
def test_expsum_sup_kernel_ragged_grids(cuda, n_grid):
    """Grids that do not fill the last block: the CPU's plain version's bits
    (the card's at 200 001), within 1e-17 of the host function."""
    kappa, tol = SUP_ROWS[3]
    co = _sup_row(kappa, tol)
    got = expsum.expsum_sup_error_dd(co.omega, co.alpha, kappa, n_grid, device=cuda)
    plain = (expsum.expsum_sup_error_dd(co.omega, co.alpha, kappa, n_grid) if n_grid <= 4001
             else _sup_plain(co, kappa, n_grid, cuda))
    assert got == plain
    assert abs(got - deflate.expsum_sup_error(co.omega, co.alpha, kappa, n_grid)) <= 1e-17


def test_expsum_sup_wrapper_rejects_bad_input(cuda):
    co = _sup_row(*SUP_ROWS[3])
    with pytest.raises(TypeError, match="on the CPU"):
        expsum.expsum_sup_error_dd(co.omega.to(cuda), co.alpha.to(cuda), 1e6, device=cuda)
    with pytest.raises(TypeError):
        expsum.expsum_sup_error_dd(co.omega.float(), co.alpha, 1e6, device=cuda)
    with pytest.raises(ValueError, match="one length"):
        expsum.expsum_sup_error_dd(co.omega, co.alpha[:-1], 1e6, device=cuda)


@pytest.mark.parametrize("storage", ["full", "twopass"])
def test_expsum_sup_one_launch_per_deflated_solve(cuda, storage):
    """solve_deflated on the card launches the sup error's kernel once, and
    its expsum_sup is the host function's of the same row within 1e-17;
    solve launches it never."""
    op, b = _deflated_problem(cuda, 40)
    cfg = tkt.SolverConfig(kmax=32, tol=1e-7, orth="lanczos" if storage == "twopass" else "lanczos_reorth")
    _build.launches.clear()
    res = tkt.solve_deflated(op, b, cfg, m=6, checkpoints=[8, 16, 24, 32], storage=storage)
    torch.cuda.synchronize()
    assert _build.launches["expsum_sup"] == 1
    kappa = res.lambda_max / res.lambda_min
    co = select_bh(torch.tensor(kappa, dtype=torch.float64), 0.5 * cfg.tol / kappa, load_tables(), cfg.tmax,
                   cfg.bh_row_select)
    assert abs(res.expsum_sup - deflate.expsum_sup_error(co.omega, co.alpha, kappa)) <= 1e-17
    _build.launches.clear()
    res = tkt.solve(op, b, tkt.SolverConfig(kmax=40, tol=1e-8))      # converges as the space fills, n = 40
    torch.cuda.synchronize()
    assert res.status == tkt.Status.CONVERGED and _build.launches["expsum_sup"] == 0


# ---- the Hessenberg QR eigensolver (csrc/hess_eig.cu) ----------------------

HESS_D, HESS_K = 10, 385


@functools.lru_cache(maxsize=1)
def _convdiff_arnoldi_H():
    """Arnoldi's H (10, 385, 385) after 304 steps on the Arnoldi cell's
    operator (conv_diff, d=10, n=131072, c=10, σ for κ=1e4), as the
    check at k = 304 sees it."""
    from tensorkrylov_tpu_torch.experiments.northstar import sigma_for_kappa
    from tensorkrylov_tpu_torch.ops.orth import arnoldi_step, init_state
    n, dev = 131072, torch.device("cuda")
    op = tkt.conv_diff(HESS_D, n, c=10.0, shift=sigma_for_kappa(n, 1e4), device=dev)
    b = tkt.random_rhs(HESS_D, n, seed=11, identical=False, device=dev)
    st, _ = init_state(op, b, HESS_K - 1, torch.float64)
    for k in range(1, 305):
        st, _ = arnoldi_step(op, st, b, k, proj_dtype=torch.float64)
    H = st.H.clone()
    del st
    torch.cuda.empty_cache()
    return H


def _hess_input(kind, dev):
    if kind == "convdiff":
        return _convdiff_arnoldi_H().to(dev)
    g = np.random.default_rng(5)
    return torch.tensor(np.triu(g.standard_normal((HESS_D, HESS_K, HESS_K)), -1), device=dev)


def _match(w, ref, scale):
    """Largest ratio, over ref's eigenvalues, of the distance to the nearest
    unused one of w (a greedy matching of the multisets) to that
    eigenvalue's scale."""
    w, used, worst = w.cpu().numpy(), np.zeros(w.numel(), bool), 0.0
    for z, sc in zip(ref.cpu().numpy(), scale):
        dist = np.where(used, np.inf, np.abs(w - z))
        j = int(np.argmin(dist))
        used[j] = True
        worst = max(worst, float(dist[j]) / sc)
    return worst


def _eig_scales(A):
    """‖A‖_F·(1 + κ_i) for each eigenvalue of A (k, k) on the CPU, κ_i its
    condition number ‖x_i‖‖y_i‖/|y_iᴴx_i| from torch.linalg.eig: a
    backward-stable Schur form moves λ_i by ~eps·‖A‖·κ_i."""
    w, V = torch.linalg.eig(A)
    kappa = torch.linalg.vector_norm(torch.linalg.inv(V), dim=1) * torch.linalg.vector_norm(V, dim=0)
    return w, (torch.linalg.matrix_norm(A) * (1.0 + kappa)).numpy()


@pytest.mark.parametrize("k", [16, 128, 304])
@pytest.mark.parametrize("kind", ["convdiff", "random"])
def test_hess_eig_kernel_matches_eig_and_twin(cuda, kind, k):
    """One launch for all ten factors (also with g = V⁻¹ b); every pair's residual
    ‖AV − VΛ‖/‖A‖ ≤ 1e-12 with unit columns; the eigenvalues as multisets
    against torch.linalg.eig of the active block, and against the plain
    version (on the CPU, first factor), within 1e-12·‖A‖·(1 + κ_i) (two
    backward-stable Schur forms: their eigenvalues differ by ~k·eps·‖A‖
    times each eigenvalue's condition number κ_i, which reaches ~1e4 in
    random Hessenbergs of order 304)."""
    from tensorkrylov_tpu_torch.ops.hess_eig import hess_eig, hess_eig_solve
    H = _hess_input(kind, cuda)
    b = torch.randn((HESS_D, k, 2), dtype=torch.float64, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    _build.launches.clear()
    (w, V, info), g = hess_eig_solve(H, k, b)
    torch.cuda.synchronize()
    assert _build.launches["hess_eig"] == 1 and not bool(info.any())
    assert all(torch.equal(x, y) for x, y in zip((w, V, info), hess_eig(H, k)))
    # g = V⁻¹ b through the triangular X: a normwise backward error near eps
    back = torch.linalg.vector_norm(V @ g - b.to(g.dtype), dim=1) / (
        torch.linalg.matrix_norm(V, ord=2)[:, None] * torch.linalg.vector_norm(g, dim=1))
    assert float(back.max()) <= 1e-13
    A = torch.triu(H[:, :k, :k], -1)
    nrm = torch.linalg.matrix_norm(A)
    res = torch.linalg.matrix_norm(A.to(V.dtype) @ V - V * w[:, None, :]) / nrm
    assert float(res.max()) <= 1e-12
    assert float((torch.linalg.vector_norm(V, dim=1) - 1.0).abs().max()) <= 1e-14
    for f in range(HESS_D):
        ref, scale = _eig_scales(A[f].cpu())
        assert _match(w[f], ref, scale) <= 1e-12, f
        if f == 0:
            plain = hess_eig(H[:1].cpu(), k)
            assert not bool(plain.info.any()) and _match(plain.w[0], ref, scale) <= 1e-12


def test_hess_eig_nonconvergence_raises_at_the_status_read(cuda):
    """A NaN never deflates: the cap stops that factor, its info is nonzero,
    and the check's status read raises as torch.linalg.eig would."""
    from tensorkrylov_tpu_torch.coeffs.tables import select_stenger
    from tensorkrylov_tpu_torch.ops.hess_eig import hess_eig
    k = 16
    H = _hess_input("random", cuda)[:2, :k + 1, :k + 1].contiguous()
    H[1, 5, 4] = float("nan")
    info = hess_eig(H, k).info.cpu()
    assert int(info[0]) == 0 and int(info[1]) > 0
    st = select_stenger(torch.tensor(1e-10), 101, torch.float64, cuda)
    bt = torch.ones((2, k + 1), dtype=torch.float64, device=cuda)
    args = (H, bt, k, st.omega, st.alpha, st.t_mask, torch.tensor(0.1, dtype=torch.float64, device=cuda))
    _, _, code = expsum.cp_solve_nonsym_eig_ex(*args, hessenberg=True)
    one = torch.tensor(1.0, dtype=torch.float64, device=cuda)
    ev = solver.ProjectedEval(one, one, one * 0.5, one, one, one, torch.tensor(3, device=cuda),
                              torch.tensor(False, device=cuda), code)
    h = solver._new_history(k + 1, torch.float64, cuda)
    with pytest.raises(torch.linalg.LinAlgError, match="did not converge"):
        solver._record_check(h, k, ev, tkt.SolverConfig(kmax=k, tol=1e-8, orth="arnoldi"))


def test_hess_eig_wrapper_rejects_bad_input(cuda):
    from tensorkrylov_tpu_torch.ops.hess_eig import MAX_K, hess_eig
    H = _hess_input("random", cuda)[:2, :8, :8].contiguous()
    with pytest.raises(TypeError):
        hess_eig(H.float(), 8)
    with pytest.raises(ValueError):
        hess_eig(H[0], 8)
    with pytest.raises(ValueError):
        hess_eig(H[:, :, :7], 7)
    for k in (0, 9):
        with pytest.raises(ValueError):
            hess_eig(H, k)
    with pytest.raises(ValueError, match="kernel takes k"):
        hess_eig(torch.zeros((1, MAX_K + 1, MAX_K + 1), dtype=torch.float64, device=cuda), MAX_K + 1)


@pytest.mark.parametrize("entry", ["solve", "solve_block"])
def test_nonsym_solve_on_card_refuses_kmax_past_hess_eig(cuda, entry):
    """kmax past the kernel's MAX_K is refused before the first step, as a
    ValueError, on solve and on a one-column solve_block."""
    from tensorkrylov_tpu_torch.ops.hess_eig import MAX_K
    op = tkt.conv_diff(2, 2 * MAX_K, device=cuda)
    b = tkt.random_rhs(2, 2 * MAX_K, seed=7, device=cuda)
    cfg = tkt.SolverConfig(kmax=MAX_K + 1, tol=1e-8, orth="arnoldi")
    _build.launches.clear()
    with pytest.raises(ValueError, match=f"kmax <= {MAX_K}"):
        tkt.solve(op, b, cfg) if entry == "solve" else tkt.solve_block(op, b[None], cfg)
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("identical", [False, True])
def test_nonsym_solve_on_card_takes_hess_eig(cuda, monkeypatch, identical):
    """A nonsymmetric solve on the card launches hess_eig once a check and
    calls torch.linalg.eig never; identical_factors passes one factor. The
    CPU solve (torch.linalg.eig) reaches the same residual history."""
    calls = []
    real = torch.linalg.eig
    monkeypatch.setattr(torch.linalg, "eig", lambda A: calls.append(A.device.type) or real(A))
    cfg = tkt.SolverConfig(kmax=30, tol=1e-8, orth="arnoldi", tmax=601, check_every=3, identical_factors=identical)
    op = tkt.conv_diff(3, 30, device=cuda)
    b = tkt.random_rhs(3, 30, seed=7, device=cuda)
    _build.launches.clear()
    res = tkt.solve(op, b, cfg)
    torch.cuda.synchronize()
    checks = sum(1 for k in range(1, res.niterations + 1) if k % cfg.check_every == 0 or k >= cfg.kmax)
    assert res.status == tkt.Status.CONVERGED and checks > 0
    assert _build.launches["hess_eig"] == checks and calls == []
    assert tkt.kron_residual_dense(op, res.x, b) <= 1e-8
    cpu = tkt.solve(tkt.conv_diff(3, 30, device="cpu"), b.cpu(), cfg)
    assert cpu.niterations == res.niterations and calls == ["cpu"] * checks
    ks = [k for k in range(1, res.niterations + 1) if k % cfg.check_every == 0]
    np.testing.assert_allclose(res.relative_residual[ks].cpu().numpy(), cpu.relative_residual[ks].numpy(), rtol=1e-6)


# ---- the entry points a user calls ----------------------------------------


def test_bench_on_card(cuda, capsys):
    """python -m tensorkrylov_tpu_torch.bench: its result line with every key,
    every rate finite and positive, through the multi-apply kernel."""
    import json

    from tensorkrylov_tpu_torch import bench

    _build.launches.clear()
    assert bench.main([]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rates = ("xla_scan_gnnz_s", "resident_pallas_gnnz_s", "cpu_numpy_gnnz_s", "solver_iters_per_s_f64",
             "solver_loop_xla_gnnz_s", "solver_loop_resident_gnnz_s", "solve_resident_gnnz_s",
             "solve_xla_segment_gnnz_s")
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert set(rates) | {"platform", "spmv_config", "roofline_3350GBps"} <= set(line["extra"])
    assert all(np.isfinite(line["extra"][r]) and line["extra"][r] > 0 for r in rates)
    assert _build.launches["resident_spmv"] > 0


def test_cli_solve_on_card(cuda, tmp_path, capsys):
    """python -m tensorkrylov_tpu_torch solve (laplace d=5, n=200, tol 1e-9):
    exit 0, CONVERGED, one banded_spmv launch per step."""
    import json

    from tensorkrylov_tpu_torch.__main__ import main as cli

    path = tmp_path / "traces.json"
    _build.launches.clear()
    rc = cli(["solve", "--gallery", "laplace", "--d", "5", "--n", "200", "--tol", "1e-9", "--json", str(path)])
    torch.cuda.synchronize()
    traces = json.loads(path.read_text())
    assert rc == 0 and traces["status"] == "CONVERGED" and "CONVERGED" in capsys.readouterr().out
    assert _build.launches["banded_spmv"] == traces["niterations"]


def test_tensorized_system_on_card(cuda):
    """TensorizedSystem and solve_tensorized_system on the card: converged,
    the dense oracle below 1e-8, one banded_spmv launch per step."""
    op = tkt.laplace(3, 30, device=cuda)
    system = tkt.TensorizedSystem.create(op, tkt.random_rhs(3, 30, seed=7, device=cuda))
    _build.launches.clear()
    res = tkt.solve_tensorized_system(system, nmax=30, tol=1e-8)
    torch.cuda.synchronize()
    assert res.status == tkt.Status.CONVERGED and _build.launches["banded_spmv"] == res.niterations
    assert tkt.kron_residual_dense(op, res.x, system.b) <= 1e-8


def test_reproduction_on_card(cuda, tmp_path):
    """The reproduction runner on the card: the reference's SPD configuration
    (d = 5, 10, 50, 100, n=200, tol 1e-9), each converged below 1e-9 and
    saved, one banded_spmv launch per step; the nonsymmetric one at d=5 below
    1e-6."""
    import json

    from tensorkrylov_tpu_torch.experiments.reproduction import run_reproduction

    dims = (5, 10, 50, 100)
    _build.launches.clear()
    spd = run_reproduction(dims, 200, device=cuda, out_dir=str(tmp_path), verbose=False)
    torch.cuda.synchronize()
    saved = json.loads((tmp_path / "reproduction_laplace_n200.json").read_text())
    assert sorted(saved) == sorted(str(d) for d in dims)
    assert all(spd[d]["status"] == tkt.Status.CONVERGED and spd[d]["final_relative_residual"] < 1e-9 for d in dims)
    assert _build.launches["banded_spmv"] == sum(spd[d]["niterations"] for d in dims)
    _build.launches.clear()
    ns = run_reproduction((5,), 200, symmetric=False, device=cuda, out_dir=str(tmp_path), verbose=False)
    torch.cuda.synchronize()
    assert ns[5]["final_relative_residual"] < 1e-6 and _build.launches["banded_spmv"] == ns[5]["niterations"]


@pytest.mark.parametrize("n", [4096, pytest.param(131072, marks=pytest.mark.slow)])
def test_multi_rhs_on_card(cuda, n):
    """solve_multi_rhs, R = 2, on the κ = 1e2 slice at n=4096 and at its
    width: lane 0 is solve's trace bit for bit, both lanes converged, x of
    rank 2·tmax, one banded_spmv launch per step of each lane."""
    op, b = _rd_problem(cuda, n, 1e2)
    b2 = tkt.random_rhs(10, n, seed=1235)
    cfg = tkt.SolverConfig(kmax=200, tol=1e-8)
    ref = tkt.solve(op, b, cfg)
    _build.launches.clear()
    mr = tkt.solve_multi_rhs(op, torch.stack([b, (b2 / torch.linalg.vector_norm(b2, dim=1, keepdim=True)).to(cuda)]),
                             cfg)
    torch.cuda.synchronize()
    x, res = mr
    assert mr.converged and torch.equal(res.relative_residual[0].cpu(), ref.relative_residual.cpu())
    assert tuple(x.factors.shape) == (10, n, 2 * cfg.tmax) and bool(torch.isfinite(x.factors).all())
    assert _build.launches["banded_spmv"] == int(res.niterations.sum())


@pytest.mark.parametrize("n", [4096, pytest.param(131072, marks=pytest.mark.slow)])
def test_solve_resumable_on_card(cuda, tmp_path, n):
    """solve_resumable on the κ = 1e2 slice at n=4096 and at its width with
    kmax=40, in chunks with a checkpoint after each, and resumed from a
    checkpoint written after 14 steps: both equal solve() bit for bit (status, steps, every
    trace, x); one banded_spmv launch per step taken."""
    from tensorkrylov_tpu_torch.solver import _segment, _setup
    from tensorkrylov_tpu_torch.utils.checkpoint import save_carry

    op, b = _rd_problem(cuda, n, 1e2)
    cfg = tkt.SolverConfig(kmax=40, tol=1e-8)
    ref = tkt.solve(op, b, cfg)
    assert ref.status == tkt.Status.CONVERGED
    ckpt = str(tmp_path / "carry.pt")
    _build.launches.clear()
    seg = tkt.solve_resumable(op, b, cfg, chunk=16, checkpoint_path=ckpt)
    torch.cuda.synchronize()
    assert _build.launches["banded_spmv"] == ref.niterations
    p, carry = _setup(op, b, cfg, None)
    save_carry(ckpt, _segment(p, carry, 14))
    _build.launches.clear()
    resumed = tkt.solve_resumable(op, b, cfg, checkpoint_path=ckpt, resume=True, chunk=9)
    torch.cuda.synchronize()
    assert _build.launches["banded_spmv"] == ref.niterations - 14
    fields = ("relative_residual", "projected_residual", "orthogonality", "lambda_min", "lambda_max", "expsum_rank")
    for got in (seg, resumed):
        assert (got.status, got.niterations) == (ref.status, ref.niterations)
        assert all(torch.equal(getattr(got, f), getattr(ref, f)) for f in fields)
        assert torch.equal(got.x.weights, ref.x.weights) and torch.equal(got.x.factors, ref.x.factors)
