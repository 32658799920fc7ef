"""The port's sharded SpMV on 8 CPU shard slots against the JAX package's:
the ring route's plain version (ops/ring_spmv.py) against the Pallas ring
kernel in interpret mode and against parallel/halo.py's shard_map SpMV on 8
virtual devices, and the gspmd route against the unsharded SpMV. The inputs
are made from a seed with numpy and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

import tensorkrylov_tpu as tk
from tensorkrylov_tpu.ops.pallas.ring_spmv import make_ring_spmv as jax_make_ring_spmv
from tensorkrylov_tpu.parallel.halo import make_halo_spmv as jax_make_halo_spmv
from tensorkrylov_tpu_torch.interop import operator_from_numpy
from tensorkrylov_tpu_torch.ops import _build
from tensorkrylov_tpu_torch.ops.banded import spmv
from tensorkrylov_tpu_torch.ops.ring_spmv import RingLaunch, make_ring_spmv, ring_spmv_local, ring_spmv_reference
from tensorkrylov_tpu_torch.parallel import gather, make_mesh, shard_operator
from tensorkrylov_tpu_torch.parallel import halo as halo_mod
from tensorkrylov_tpu_torch.parallel import shard_rhs
from tensorkrylov_tpu_torch.parallel.halo import exchange_halos, make_halo_spmv, ring_sources, spmv_halo, spmv_sharded

CPU8 = [torch.device("cpu")] * 8
WIDE = (-7, -2, 0, 3, 5)


def _jax_devices():
    devs = jax.devices()
    assert len(devs) >= 8, "tests/conftest.py sets 8 virtual devices"
    return np.asarray(devs[:8])


def _bands(offsets, d, n, seed, dtype):
    """Random bands with the operator's convention: out-of-range entries are zero."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((d, len(offsets), n))
    for b, off in enumerate(offsets):
        if off > 0:
            bands[:, b, n - off:] = 0.0
        elif off < 0:
            bands[:, b, :-off] = 0.0
    return bands.astype(dtype), rng.standard_normal((d, n)).astype(dtype)


def _ring(mesh_devices, offsets, bands, v):
    before = dict(_build.launches)
    out = make_ring_spmv(make_mesh(devices=mesh_devices), offsets)(torch.tensor(bands), torch.tensor(v))
    assert dict(_build.launches) == before  # CPU shards take the plain version
    return out.numpy()


def test_ring_matches_pallas_ring_laplace():
    """laplace(3, 8·256) in f32: one offset on each side, so the Pallas kernel
    adds its corrections in halo.py's order too; 1e-6 relative to max |u|.
    The terms are O(n²) and cancel to O(n²)·|Δv|, so a one-ulp difference
    between XLA's and torch's rounding is up to 4e-5 of a cancelled entry:
    an elementwise rtol would measure the cancellation, not the port."""
    n = 8 * 256
    jop = tk.laplace(3, n, dtype=jnp.float32)
    v = np.random.default_rng(0).standard_normal((3, n)).astype(np.float32)
    fn = jax_make_ring_spmv(Mesh(_jax_devices(), ("mode",)), jop.offsets, "mode",
                            interpret=pltpu.InterpretParams())
    ref = np.asarray(fn(jop.bands, jnp.asarray(v)))
    got = _ring(CPU8, jop.offsets, np.asarray(jop.bands), v)
    assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref))


def test_ring_matches_pallas_ring_wide_band():
    """Offsets up to 7 at n = 8·128, as tests/test_ring_spmv.py:43: two
    offsets on a side, which the Pallas kernel sums before adding them, so
    the two differ in rounding; rtol and atol 1e-5."""
    n = 8 * 128
    bands, v = _bands(WIDE, 2, n, 3, np.float32)
    fn = jax_make_ring_spmv(Mesh(_jax_devices(), ("mode",)), WIDE, "mode", interpret=pltpu.InterpretParams())
    ref = np.asarray(fn(jnp.asarray(bands), jnp.asarray(v)))
    np.testing.assert_allclose(_ring(CPU8, WIDE, bands, v), ref, rtol=1e-5, atol=1e-5)


def test_ring_matches_jax_halo_spmv_f64():
    """conv_diff(3, 64) in f64 against parallel/halo.py's shard_map SpMV, whose
    order the port follows: rtol 1e-12."""
    jop = tk.conv_diff(3, 64)
    v = np.random.default_rng(7).standard_normal((3, 64))
    fn = jax_make_halo_spmv(Mesh(_jax_devices().reshape(1, 8), ("factor", "mode")), jop.offsets)
    ref = np.asarray(fn(jop.bands, jnp.asarray(v)))
    np.testing.assert_allclose(_ring(CPU8, jop.offsets, np.asarray(jop.bands), v), ref, rtol=1e-12)


@pytest.mark.parametrize("comm", ["ring", "gspmd"])
@pytest.mark.parametrize("offsets,n", [((-1, 0, 1), 64), ((-2, -1, 0, 1, 2), 40), (WIDE, 56)],
                         ids=["tri", "penta", "wide_shard_is_H"])
@pytest.mark.parametrize("shape", ["dn", "dmn"])
@pytest.mark.parametrize("factor_parallel", [1, 2])
def test_sharded_spmv_matches_unsharded(factor_parallel, shape, offsets, n, comm):
    """The gspmd route is the unsharded SpMV bit for bit (its slab sums follow
    the unsharded band order); the ring route agrees to rounding, its edge
    rows summed interior first. n = 56 gives the wide band 7-column shards,
    exactly H wide."""
    d = 4
    bands, _ = _bands(offsets, d, n, 11, np.float64)
    vshape = (d, n) if shape == "dn" else (d, 3, n)
    v = torch.tensor(np.random.default_rng(12).standard_normal(vshape))
    op = operator_from_numpy(bands, offsets)
    mesh = make_mesh(devices=CPU8, factor_parallel=factor_parallel)
    got, ref = spmv_halo(op, v, mesh, comm), spmv(op, v)
    assert tuple(got.shape) == vshape
    if comm == "gspmd":
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-14 * float(ref.abs().max()))


def test_one_shard_ring_is_the_spmv():
    """One shard has zero halos: its interior is the whole SpMV, each term in
    band order (out-of-range ones as band·0), so the values equal spmv's."""
    bands, v = _bands(WIDE, 3, 33, 4, np.float64)
    op = operator_from_numpy(bands, WIDE)
    got = make_ring_spmv(make_mesh(devices=[torch.device("cpu")]), WIDE)(op.bands, torch.tensor(v))
    assert torch.equal(got, spmv(op, torch.tensor(v)))


def test_ring_batched_columns_are_each_column():
    """(d, m, n) through the ring route: each of the m columns gives the bits
    of its own (d, n) call."""
    bands, _ = _bands(WIDE, 2, 64, 5, np.float32)
    v = torch.tensor(np.random.default_rng(6).standard_normal((2, 4, 64)).astype(np.float32))
    fn = make_halo_spmv(make_mesh(devices=CPU8), WIDE)
    got = fn(torch.tensor(bands), v)
    for j in range(4):
        assert torch.equal(got[:, j], fn(torch.tensor(bands), v[:, j].contiguous()))


def test_plain_version_adds_corrections_in_band_order():
    """A shard whose H-wide head is corrected by two lower bands: the plain
    version adds each correction to the result in turn, as halo.py:95-106."""
    offsets = (-2, -1, 0)
    bands = torch.tensor(np.random.default_rng(8).standard_normal((1, 3, 4)))
    v = torch.tensor(np.random.default_rng(9).standard_normal((1, 4)))
    lh, rh = torch.tensor([[0.3, -1.7]]), torch.zeros((1, 2), dtype=torch.float64)
    op = operator_from_numpy(bands.numpy(), offsets)
    u = bands[:, 0] * torch.cat([torch.zeros(1, 2, dtype=torch.float64), v[:, :2]], -1)
    u = u + bands[:, 1] * torch.cat([torch.zeros(1, 1, dtype=torch.float64), v[:, :3]], -1)
    u = u + bands[:, 2] * v
    u[:, :2] += bands[:, 0, :2] * lh
    u[:, :1] += bands[:, 1, :1] * lh[:, 1:]
    assert torch.equal(ring_spmv_reference(op, v, lh, rh), u)


def test_bad_layouts_raise():
    mesh = make_mesh(devices=CPU8)
    op = operator_from_numpy(_bands(WIDE, 2, 44, 1, np.float64)[0], WIDE)
    with pytest.raises(ValueError, match="multiple of the 8 mode shards"):
        shard_operator(op, mesh)                     # n % n_mode != 0
    op = operator_from_numpy(_bands(WIDE, 2, 48, 1, np.float64)[0], WIDE)
    with pytest.raises(ValueError, match="narrower than the halo width 7"):
        shard_operator(op, mesh)                     # 6-column shards, H = 7
    with pytest.raises(ValueError, match="cpu or cuda"):
        make_mesh(devices=[torch.device("meta")] * 2)
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        make_mesh(devices=[torch.device("cpu"), torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="factor_parallel"):
        make_mesh(devices=CPU8, factor_parallel=3)
    meta = torch.empty((2, 8), dtype=torch.float64, device="meta")
    halo = torch.empty((2, 7), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ring_spmv_local(operator_from_numpy(_bands(WIDE, 2, 8, 1, np.float64)[0], WIDE), meta, halo, halo)


@pytest.mark.parametrize("comm", ["ring", "gspmd"])
def test_shard_operator_keeps_the_route_bands(comm):
    """Each shard keeps only the bands its route reads: its own columns for
    'ring', the H-padded slab for 'gspmd'; another comm raises."""
    op = operator_from_numpy(_bands(WIDE, 2, 64, 13, np.float64)[0], WIDE)
    sop = shard_operator(op, make_mesh(devices=CPU8), comm)
    assert sop.comm == comm
    widths = {tuple(sh.op.bands.shape) for sh in sop.shards}
    assert widths == {(2, 5, 8 if comm == "ring" else 8 + 2 * 7)}
    with pytest.raises(ValueError, match="comm must be 'gspmd' or 'ring'"):
        shard_operator(op, make_mesh(devices=CPU8), "ppermute")


@pytest.mark.parametrize("comm", ["ring", "gspmd"])
def test_halo_buffers_are_reused(comm):
    """One sharded operator, two different v: the second exchange writes the
    same buffers, the chain ends stay zero, and both results are right."""
    bands, _ = _bands(WIDE, 2, 64, 14, np.float64)
    op = operator_from_numpy(bands, WIDE)
    mesh = make_mesh(devices=CPU8)
    sop = shard_operator(op, mesh, comm)
    rng = np.random.default_rng(15)
    first = None
    for _ in range(2):
        v = torch.tensor(rng.standard_normal((2, 64)))
        vs = shard_rhs(v, mesh)
        got = gather(spmv_sharded(sop, vs), mesh)
        torch.testing.assert_close(got, spmv(op, v), rtol=0, atol=1e-14 * float(got.abs().max()))
        halos, _ = exchange_halos(sop, vs)
        first = first or halos
        assert all(a is c and b is e for (a, b), (c, e) in zip(halos, first))
        assert not halos[0][0].any() and not halos[-1][1].any()
        assert torch.equal(halos[1][0], vs[0][..., -7:]) and torch.equal(halos[0][1], vs[1][..., :7])
    assert len(sop.halo_buffers) == 1


def test_ring_launches_every_interior_before_any_edge(monkeypatch):
    """The ring route queues all P interiors, then the P edges: no interior
    waits behind another shard's halo event."""
    calls = []
    interior, edge = halo_mod.ring_spmv_interior, halo_mod.ring_spmv_edge
    monkeypatch.setattr(halo_mod, "ring_spmv_interior", lambda *a: calls.append("interior") or interior(*a))
    monkeypatch.setattr(halo_mod, "ring_spmv_edge", lambda *a: calls.append("edge") or edge(*a))
    bands, v = _bands(WIDE, 2, 64, 16, np.float64)
    got = spmv_halo(operator_from_numpy(bands, WIDE), torch.tensor(v), make_mesh(devices=CPU8), "ring")
    assert calls == ["interior"] * 8 + ["edge"] * 8
    torch.testing.assert_close(got, spmv(operator_from_numpy(bands, WIDE), torch.tensor(v)), rtol=0, atol=1e-13)


def test_make_halo_spmv_shards_the_bands_once(monkeypatch):
    """The function splits a bands tensor once and reuses the split while it
    is given the same tensor; new bands are split anew."""
    splits = []
    real = halo_mod.shard_operator
    monkeypatch.setattr(halo_mod, "shard_operator", lambda *a: splits.append(1) or real(*a))
    bands, v = _bands(WIDE, 2, 64, 17, np.float64)
    fn = make_halo_spmv(make_mesh(devices=CPU8), WIDE)
    tb, tv = torch.tensor(bands), torch.tensor(v)
    first = fn(tb, tv)
    assert torch.equal(fn(tb, tv), first) and len(splits) == 1
    fn(tb.clone(), tv)
    assert len(splits) == 2


@pytest.mark.parametrize("factor_parallel", [1, 2])
@pytest.mark.parametrize("shape", ["dn", "dmn"])
def test_ring_sources_read_the_halos(factor_parallel, shape):
    """The sources the ring kernel reads in place (a neighbour's v, its row
    stride and column base) address exactly the columns that the exchange
    copies into the halo buffers; None at each group's chain ends."""
    bands, _ = _bands(WIDE, 4, 64, 18, np.float64)
    mesh = make_mesh(devices=CPU8, factor_parallel=factor_parallel)
    sop = shard_operator(operator_from_numpy(bands, WIDE), mesh, "ring")
    vshape = (4, 64) if shape == "dn" else (4, 3, 64)
    vs = shard_rhs(torch.tensor(np.random.default_rng(19).standard_normal(vshape)), mesh)
    halos, _ = exchange_halos(sop, vs)
    H, P = sop.halo, sop.n_mode
    for q, ((left, right), (lh, rh)) in enumerate(zip(ring_sources(sop, vs), halos)):
        for src, halo, end, lo in ((left, lh, q % P == 0, -H), (right, rh, q % P == P - 1, 0)):
            if end:
                assert src is None and not halo.any()
                continue
            rows = src.tensor.reshape(-1, src.tensor.shape[-1])
            read = rows[:, src.base + lo:src.base + lo + H].reshape(halo.shape)
            assert torch.equal(read, halo)


def test_ring_across_cards_without_peer_access_raises(monkeypatch):
    """The ring route reads a neighbour's v on another card in place; where
    the cards cannot reach each other it raises before any copy and names
    the route that copies instead."""
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)
    op = operator_from_numpy(_bands(WIDE, 2, 64, 20, np.float64)[0], WIDE)
    mesh = make_mesh(devices=[torch.device("cuda", i % 2) for i in range(4)])
    with pytest.raises(ValueError, match="comm='gspmd'"):
        shard_operator(op, mesh, "ring")


def test_ring_kernel_launch_takes_cuda_shards_only():
    """A RingLaunch is the kernel's launch: CPU shards take the plain version
    (ring_spmv_local, spmv_sharded) and are refused here, and a CPU ring
    operator builds none."""
    bands, _ = _bands(WIDE, 2, 8, 21, np.float64)
    op = operator_from_numpy(bands, WIDE)
    with pytest.raises(ValueError, match="CUDA shards"):
        RingLaunch([op])
    assert shard_operator(op, make_mesh(devices=[torch.device("cpu")]), "ring").ring == ()
