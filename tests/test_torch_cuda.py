"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and a solve that must go through them. These tests skip where no
CUDA device is present. This file imports no JAX, so on a machine with the
card and without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.ops import _build, _cluster
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


@pytest.mark.parametrize("shape", [(3, 1001), (3, 4, 1001), (10, 131072)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_kernel_equals_plain(cuda, dtype, shape):
    """Same products, summed in the same order, each rounded: equal bits."""
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
@pytest.mark.parametrize("G", [1, 2, 8, 16])
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


@pytest.mark.parametrize("entry", ["solve", "solve_host_projected"])
def test_arnoldi_conv_diff_on_card(cuda, entry):
    """The verify recipe on the card: the dense-oracle residual is ≤ 1e-8."""
    op = tkt.conv_diff(3, 30, device=cuda)
    b = tkt.random_rhs(3, 30, seed=7, device=cuda)
    _build.launches.clear()
    res = getattr(tkt, entry)(op, b, tkt.SolverConfig(kmax=30, tol=1e-8, orth="arnoldi", tmax=601))
    assert res.status == tkt.Status.CONVERGED and _build.launches["banded_spmv"] == res.niterations
    assert tkt.kron_residual_dense(op, res.x, b) <= 1e-8


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


@pytest.mark.parametrize("step_impl,launches", [("fused", {"fused_lanczos": 1, "banded_spmv": 1}),
                                                ("auto", {"banded_spmv": 2})])
def test_solve_two_pass_on_card_equals_cpu(cuda, step_impl, launches):
    """Per step: pass 1's fused core and pass 2's SpMV, or one SpMV in each
    pass; status, steps and residual trace as on the CPU (each device's
    eigh rounds the projected stage its own way). The fused route's pass 1
    runs one recurrence on both devices, bit for bit (the fused core and the
    start's sums in a fixed order, sqrt correctly rounded)."""
    from tensorkrylov_tpu_torch import twopass
    from tensorkrylov_tpu_torch.coeffs.tables import load_tables

    cfg = tkt.SolverConfig(kmax=60, tol=1e-8, orth="lanczos", step_impl=step_impl)
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
    Lanczos amplifies each device's rounding apart."""
    cfg = tkt.SolverConfig(kmax=32, tol=1e-7, orth="lanczos" if storage == "twopass" else "lanczos_reorth")
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
    assert dict(_build.launches) == {"banded_spmv": steps + 1}
    assert got.cp_residual_floor is not None and got.measured_cp_residual is not None


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


def test_gram_dot2_on_card_equals_cpu(cuda):
    """The device cross-check's compensated Gram: every operation a rounded
    IEEE op in the same tree order on both devices, so the card's (hi, lo)
    pairs equal the CPU's bit for bit (no product fused into an FMA)."""
    from tensorkrylov_tpu_torch.utils.cp import _gram_dot2

    g = torch.Generator().manual_seed(5)
    C = torch.randn((3, 7, 40001), dtype=torch.float64, generator=g) * torch.logspace(-4, 4, 40001, dtype=torch.float64)
    hi, lo = _gram_dot2(C)
    hi_c, lo_c = _gram_dot2(C.to(cuda))
    assert torch.equal(hi_c.cpu(), hi) and torch.equal(lo_c.cpu(), lo)
