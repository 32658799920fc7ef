"""Factor × mode sharding: counterpart of ``tensorkrylov_tpu/parallel/sharding.py``.

The JAX package places its operands on a ('factor', 'mode') device mesh and
lets GSPMD insert the collectives. The port is single-controller in the same
way: one process drives a grid of shard slots, each a ``torch.device``, and a
device may repeat (P shards on one card share ``cuda:0``). On the ring route
the kernel reads a neighbouring shard's edge in place, across cards through
peer access, which ``shard_operator`` enables; on the gspmd route each CUDA
shard has a side stream for its halo copies (a peer copy across cards).

  * 'mode' splits each factor's length-n axis into n_mode contiguous slices;
    the SpMV exchanges H-wide edges between neighbours (``parallel/halo.py``)
    and every n-sized dot is a per-shard partial sum, summed on the lead device
    in shard order (``parallel/krylov.py``).
  * 'factor' splits the d recurrences into factor_parallel groups when
    d % factor_parallel == 0 (``sharding.py:51-53``). Otherwise the factor
    axis is not used: the shards of the mesh's first row do all the work, where
    the JAX package would replicate it over the factor axis.

The k-sized projected stage runs on the lead device (the first slot), as the
JAX package replicates it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import _build
from ..ops.ring_spmv import RingLaunch, halo_width
from ..types import KroneckerSumOperator, SolveResult, SolverConfig

__all__ = ["Mesh", "Shard", "ShardedOperator", "make_mesh", "shard_operator", "shard_rhs", "gather",
           "solve_sharded"]

COMMS = ("gspmd", "ring")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (factor_parallel, n_mode) grid of shard slots."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("factor", "mode")

    @property
    def shape(self) -> dict:
        return {"factor": len(self.devices), "mode": len(self.devices[0])}

    @property
    def lead(self) -> torch.device:
        """Where the replicated projected stage and the gathered results live."""
        return self.devices[0][0]


def _normalize(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a shard runs on a cpu or cuda device, got {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, factor_parallel: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ('factor', 'mode') mesh of the first n_devices of devices, which
    default to every CUDA device and may repeat:
    ``make_mesh(devices=[torch.device("cuda:0")] * 4)`` is 4 mode shards on
    one card, ``make_mesh(devices=[torch.device("cpu")] * 8)`` 8 on the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')] * P for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_normalize(dev) for dev in devices]
    n_devices = len(devices) if n_devices is None else n_devices
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices} but {len(devices)} devices were given")
    if factor_parallel < 1 or n_devices % factor_parallel:
        raise ValueError(f"factor_parallel={factor_parallel} does not divide n_devices={n_devices}")
    devices = devices[:n_devices]
    if len({dev.type for dev in devices}) > 1:
        raise ValueError(f"a mesh is all cpu or all cuda, got {sorted({str(dev) for dev in devices})}")
    P = n_devices // factor_parallel
    return Mesh(tuple(tuple(devices[g * P:(g + 1) * P]) for g in range(factor_parallel)))


def _factor_groups(mesh: Mesh, d: int) -> List[Tuple[int, int]]:
    """The factor ranges [s0, s1) of the mesh rows in use."""
    fp = mesh.shape["factor"]
    if fp > 1 and d % fp == 0:
        return [(g * d // fp, (g + 1) * d // fp) for g in range(fp)]
    return [(0, d)]


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """One slot's part of the operator: factors [s0, s1), columns [c0, c1).
    op holds the bands that the route reads: columns [c0, c1) for 'ring';
    [c0 − H, c1 + H), zero outside [0, n), for 'gspmd'."""

    device: torch.device
    factors: Tuple[int, int]
    cols: Tuple[int, int]
    op: KroneckerSumOperator
    side: Optional[torch.cuda.Stream]  # where the shard's halos are copied (CUDA shards of 'gspmd')


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedOperator:
    """A Kronecker-sum operator split over a mesh; shards are group-major
    (shard g·n_mode + p holds factor group g, mode slice p). comm selects the
    per-shard SpMV: 'ring' the ring kernel, 'gspmd' the banded_spmv kernel on
    the halo-extended slab. ring holds, for CUDA shards of 'ring', each
    card's (device, shard indices, RingLaunch), its bands checked once.
    halo_buffers keeps each shard's (left, right) halo buffers per (shape,
    dtype) of v, reused by every exchange (parallel/halo.py)."""

    mesh: Mesh
    shards: Tuple[Shard, ...]
    offsets: Tuple[int, ...]
    symmetric: bool
    d: int
    n: int
    comm: str
    ring: Tuple[Tuple[torch.device, Tuple[int, ...], RingLaunch], ...] = ()
    halo_buffers: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_mode(self) -> int:
        return self.mesh.shape["mode"]

    @property
    def halo(self) -> int:
        return halo_width(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].op.dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.lead


def _split(x: torch.Tensor, mesh: Mesh, d: int, factor_axis: int = 0) -> List[torch.Tensor]:
    """x's factor axis over the factor groups and its last axis over the mode
    shards, each piece contiguous on its slot's device."""
    P = mesh.shape["mode"]
    n = x.shape[-1]
    if n % P:
        raise ValueError(f"n={n} is not a multiple of the {P} mode shards")
    nl = n // P
    pieces = []
    for g, (s0, s1) in enumerate(_factor_groups(mesh, d)):
        rows = x.narrow(factor_axis, s0, s1 - s0)
        pieces += [rows[..., p * nl:(p + 1) * nl].contiguous().to(mesh.devices[g][p]) for p in range(P)]
    return pieces


def _enable_ring_peers(mesh: Mesh) -> None:
    """The ring kernel reads its neighbours' v in place, so each card must
    reach its chain neighbours' memory: peer access both ways, or an error
    that names the route that copies instead."""
    pairs = {(a.index, b.index) for row in mesh.devices for x, y in zip(row, row[1:])
             for a, b in ((x, y), (y, x)) if a.type == "cuda" and a != b}
    for a, b in sorted(pairs):
        if not torch.cuda.can_device_access_peer(a, b):
            raise ValueError(f"comm='ring' reads the neighbouring shards' edges in place, but cuda:{a} cannot "
                             f"access cuda:{b}; use comm='gspmd', which copies them")
    for a, b in sorted(pairs):
        _build.check(_build.kernels().tk_enable_peer_access(a, b), f"peer access cuda:{a} -> cuda:{b}")


def shard_operator(op: KroneckerSumOperator, mesh: Mesh, comm: str = "gspmd") -> ShardedOperator:
    """bands (d, nb, n): n over 'mode', d over 'factor' when it divides d,
    each shard keeping the bands that comm's SpMV reads. Needs
    n % n_mode == 0 and a shard at least H = max |offset| wide. 'ring' on
    several cards enables peer access between neighbouring cards and raises
    where the card cannot; 'gspmd' gives each CUDA shard a side stream."""
    if comm not in COMMS:
        raise ValueError(f"comm must be 'gspmd' or 'ring', got {comm!r}")
    P, H = mesh.shape["mode"], halo_width(op.offsets)
    if op.n % P:
        raise ValueError(f"n={op.n} is not a multiple of the {P} mode shards")
    nl = op.n // P
    if nl < H:
        raise ValueError(f"a shard of {nl} columns is narrower than the halo width {H}")
    if comm == "ring":
        _enable_ring_peers(mesh)
    # gspmd: column c of the operator at c + H, so a shard's slab starts at c0
    bands, width = (op.bands, nl) if comm == "ring" else (F.pad(op.bands, (H, H)), nl + 2 * H)
    shards = []
    for g, (s0, s1) in enumerate(_factor_groups(mesh, op.d)):
        for p in range(P):
            dev, c0 = mesh.devices[g][p], p * nl
            mine = bands[s0:s1, :, c0:c0 + width].contiguous().to(dev)
            side = torch.cuda.Stream(device=dev) if dev.type == "cuda" and comm == "gspmd" else None
            shards.append(Shard(dev, (s0, s1), (c0, c0 + nl), KroneckerSumOperator(mine, op.offsets, op.symmetric),
                                side))
    ring = ()
    if comm == "ring" and shards[0].device.type == "cuda":
        cards = {}
        for q, sh in enumerate(shards):
            cards.setdefault(sh.device, []).append(q)
        ring = tuple((dev, tuple(qs), RingLaunch([shards[q].op for q in qs])) for dev, qs in cards.items())
    return ShardedOperator(mesh, tuple(shards), op.offsets, op.symmetric, op.d, op.n, comm, ring)


def shard_rhs(b: torch.Tensor, mesh: Mesh, d: Optional[int] = None) -> List[torch.Tensor]:
    """b (d, …, n) split as shard_operator splits the bands: one piece per
    shard, (d_f, …, n / n_mode) on its device."""
    b = torch.as_tensor(b)
    return _split(b, mesh, d or b.shape[0])


def gather(pieces: Sequence[torch.Tensor], mesh: Mesh, axis: int = -1, factor_axis: int = 0) -> torch.Tensor:
    """The inverse of the split: the pieces of each factor group joined along
    axis (the mode axis), the groups along factor_axis, on the lead device."""
    P = mesh.shape["mode"]
    rows = [torch.cat([x.to(mesh.lead) for x in pieces[g * P:(g + 1) * P]], dim=axis)
            for g in range(len(pieces) // P)]
    return torch.cat(rows, dim=factor_axis)


def solve_sharded(op: KroneckerSumOperator, b, config: Optional[SolverConfig] = None, mesh: Optional[Mesh] = None,
                  comm: str = "gspmd", tables=None) -> SolveResult:
    """Solve with the operator, the right-hand side and the Krylov bases split
    over the mesh; the projected stage runs on the lead device.

    comm: 'gspmd' — each shard's SpMV is the banded_spmv kernel on its slab
          [left halo | columns | right halo], bit-equal to the unsharded SpMV;
          'ring'  — every SpMV is one ring kernel launch per card, which
          reads the neighbouring shards' edges in place (peer access
          across cards).
    step_impl is forced to 'xla' (``sharding.py:95-98``); SolveResult.config
    records it. The solution is gathered to the lead device, (d, n, t) there,
    where the JAX package leaves it sharded.
    """
    from ..solver import solve_on_mesh  # the solver imports this package's steps

    if comm not in COMMS:  # before any work; shard_operator checks it too
        raise ValueError(f"comm must be 'gspmd' or 'ring', got {comm!r}")
    mesh = mesh if mesh is not None else make_mesh()
    config = config or SolverConfig()
    if config.step_impl != "xla":
        config = dataclasses.replace(config, step_impl="xla")
    return solve_on_mesh(op, b, config, mesh, comm, tables)
