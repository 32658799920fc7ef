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
JAX package replicates it. A mesh may carry an 'rhs' axis over its grid
(``make_mesh(rhs_parallel=G)``): G groups, each a ('factor', 'mode') grid of
its own, over which solve_multi_rhs spreads its right-hand sides; an operator
or a vector is split over one grid.

A mesh may span processes (``multihost.make_pod_mesh``): each slot then has
an owner rank, and every process builds and holds only the shards of the
slots it owns (a ShardedOperator's ``shards``, a vector's pieces, in shard
order). What needs every shard's piece, a psum's partials or a gathered
vector, is all-gathered (``allgather``): each rank then has the same whole,
and its lead device, its first owned slot's, runs the same projected stage.
A one-process mesh is the case where this process owns every slot.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops import _build
from ..ops.ring_spmv import RingLaunch, halo_width
from ..types import KroneckerSumOperator, SolveResult, SolverConfig

__all__ = ["Mesh", "Shard", "ShardedOperator", "make_mesh", "shard_operator", "shard_rhs", "rhs_pieces", "shard_basis",
           "gather", "allgather", "comm_stats", "solve_sharded"]

COMMS = ("gspmd", "ring")

# Cross-process traffic since the last clear(): for each kind ('psum': the
# partial sums' all-gathers; 'gather': whole vectors; 'halo': the edges) its
# calls, its bytes (this rank's share sent), the bytes that went through
# pinned host buffers, and the seconds it took on the host's clock.
comm_stats: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (factor_parallel, n_mode) grid of shard slots; with rhs groups, a
    ('rhs', 'factor', 'mode') mesh: groups[g] is rhs group g's grid, and
    devices is group 0's. A solve shards over one grid: rhs_groups() gives
    each group's grid as a mesh of its own (solver.solve_multi_rhs)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, ...] = ("factor", "mode")
    groups: Tuple[Tuple[Tuple[torch.device, ...], ...], ...] = ()
    # across processes: the rank that owns each slot (its device is named as
    # that rank names it) and this process's rank; () is one process
    ranks: Tuple[Tuple[int, ...], ...] = ()
    rank: int = 0

    def __post_init__(self):
        if self.processes > 1 and self.groups:
            raise NotImplementedError("a mesh with rhs groups across processes is not ported: solve_multi_rhs runs "
                                      "its groups in turn under one controller (ROADMAP.md Queue 1, #14)")
        if self.ranks and not any(self.rank in row for row in self.ranks):
            raise ValueError(f"process {self.rank} owns no slot of the mesh {self.ranks}")

    @property
    def shape(self) -> dict:
        grid = {"factor": len(self.devices), "mode": len(self.devices[0])}
        return {"rhs": len(self.groups), **grid} if self.groups else grid

    @property
    def processes(self) -> int:
        """How many processes own slots of the mesh."""
        return len({r for row in self.ranks for r in row}) if self.ranks else 1

    def owner(self, g: int, p: int) -> int:
        """The rank that owns slot (g, p)."""
        return self.ranks[g][p] if self.ranks else self.rank

    def owns(self, g: int, p: int) -> bool:
        return self.owner(g, p) == self.rank

    @property
    def lead(self) -> torch.device:
        """Where the replicated projected stage and the gathered results live:
        this process's first slot."""
        return next(dev for g, row in enumerate(self.devices) for p, dev in enumerate(row) if self.owns(g, p))

    def rhs_groups(self) -> Tuple["Mesh", ...]:
        """Each rhs group's ('factor', 'mode') grid as a mesh; a 2-D mesh is its own one group."""
        return tuple(Mesh(grid) for grid in self.groups) if self.groups else (self,)


def _normalize(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a shard runs on a cpu or cuda device, got {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, factor_parallel: int = 1, devices: Optional[Sequence] = None,
              rhs_parallel: int = 1) -> Mesh:
    """A ('factor', 'mode') mesh of the first n_devices of devices, which
    default to every CUDA device and may repeat:
    ``make_mesh(devices=[torch.device("cuda:0")] * 4)`` is 4 mode shards on
    one card, ``make_mesh(devices=[torch.device("cpu")] * 8)`` 8 on the CPU.
    rhs_parallel > 1 makes a ('rhs', 'factor', 'mode') mesh of that many rhs
    groups, each a (factor_parallel, n_mode) grid of consecutive devices (the
    JAX dry run's ``Mesh(grid.reshape(2, 2, P), ('rhs', 'factor', 'mode'))``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')] * P for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_normalize(dev) for dev in devices]
    n_devices = len(devices) if n_devices is None else n_devices
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"n_devices={n_devices} but {len(devices)} devices were given")
    if rhs_parallel < 1 or n_devices % rhs_parallel:
        raise ValueError(f"rhs_parallel={rhs_parallel} does not divide n_devices={n_devices}")
    per_group = n_devices // rhs_parallel
    if factor_parallel < 1 or per_group % factor_parallel:
        raise ValueError(f"factor_parallel={factor_parallel} does not divide the {per_group} devices of an rhs group")
    devices = devices[:n_devices]
    if len({dev.type for dev in devices}) > 1:
        raise ValueError(f"a mesh is all cpu or all cuda, got {sorted({str(dev) for dev in devices})}")
    P = per_group // factor_parallel
    grids = tuple(tuple(tuple(devices[(r * factor_parallel + g) * P:(r * factor_parallel + g + 1) * P])
                        for g in range(factor_parallel)) for r in range(rhs_parallel))
    if rhs_parallel == 1:
        return Mesh(grids[0])
    return Mesh(grids[0], ("rhs", "factor", "mode"), grids)


def _grid(mesh: Mesh) -> Mesh:
    """mesh itself where it is one ('factor', 'mode') grid; a mesh with rhs
    groups raises: an operator or a vector is split over one group's grid."""
    if mesh.groups:
        raise ValueError(f"a mesh with rhs groups {mesh.shape} splits the right-hand sides: solve_multi_rhs(op, B, "
                         f"mesh=mesh) runs each group on its own grid; split an operator over one of "
                         f"mesh.rhs_groups()")
    return mesh


def _factor_groups(mesh: Mesh, d: int) -> List[Tuple[int, int]]:
    """The factor ranges [s0, s1) of the mesh rows in use."""
    fp = mesh.shape["factor"]
    if fp > 1 and d % fp == 0:
        return [(g * d // fp, (g + 1) * d // fp) for g in range(fp)]
    return [(0, d)]


def _owned(mesh: Mesh, d: int) -> List[Tuple[int, int, int, Tuple[int, int]]]:
    """(shard index q = g·n_mode + p, g, p, factors) of the shards in use that
    this process owns, in shard order. Across processes every rank must own
    as many of them (an all-gather stacks one piece per shard), so a layout
    that leaves a rank idle raises."""
    P = mesh.shape["mode"]
    used = [(g * P + p, g, p, fr) for g, fr in enumerate(_factor_groups(mesh, d)) for p in range(P)]
    if mesh.processes > 1:
        counts = collections.Counter(mesh.owner(g, p) for _, g, p, _ in used)
        owners = {r for row in mesh.ranks for r in row}
        if set(counts) != owners or len(set(counts.values())) != 1:
            raise ValueError(f"the {len(used)} shards in use for d={d} on the mesh {mesh.shape} fall unevenly on its "
                             f"processes ({dict(counts)} of {sorted(owners)}): every rank must own as many; take "
                             f"factor_parallel dividing d, or 1")
    return [u for u in used if mesh.owns(u[1], u[2])]


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
    index: int                         # q = g·n_mode + p in the whole layout


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedOperator:
    """A Kronecker-sum operator split over a mesh; shards are group-major
    (shard g·n_mode + p holds factor group g, mode slice p), this process's
    own only where the mesh spans processes. comm selects the
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
    def n_shards(self) -> int:
        """The shards of the whole layout, every process's."""
        return len(_factor_groups(self.mesh, self.d)) * self.n_mode

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].op.dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.lead

    def astype(self, dtype) -> "ShardedOperator":
        """The same split with every shard's bands in dtype (on the ring
        route the cards' launches are made again for them)."""
        if dtype == self.dtype:
            return self
        shards = tuple(dataclasses.replace(sh, op=sh.op.astype(dtype)) for sh in self.shards)
        return dataclasses.replace(self, shards=shards, ring=_ring_launches(shards) if self.ring else (),
                                   halo_buffers={})

    def leading_bands(self, cols: int) -> torch.Tensor:
        """The operator's bands at columns [0, cols), (d, nb, cols) on the lead
        device: the shards' own columns (a gspmd shard's sit at [H, H +
        n_local) of its slab) gathered, then cut."""
        H = self.halo if self.comm == "gspmd" else 0
        own = [sh.op.bands[..., H:H + sh.cols[1] - sh.cols[0]] for sh in self.shards]
        return gather(own, self.mesh)[..., :cols]


def _split(x: torch.Tensor, mesh: Mesh, d: int, factor_axis: int = 0) -> List[torch.Tensor]:
    """x's factor axis over the factor groups and its last axis over the mode
    shards, each piece contiguous on its slot's device."""
    P = mesh.shape["mode"]
    n = x.shape[-1]
    if n % P:
        raise ValueError(f"n={n} is not a multiple of the {P} mode shards")
    nl = n // P
    return [x.narrow(factor_axis, s0, s1 - s0)[..., p * nl:(p + 1) * nl].contiguous().to(mesh.devices[g][p])
            for _, g, p, (s0, s1) in _owned(mesh, d)]


def _enable_ring_peers(mesh: Mesh) -> None:
    """The ring kernel reads its neighbours' v in place, so each card must
    reach its chain neighbours' memory: peer access both ways, or an error
    that names the route that copies instead. A neighbour in another process
    is not read in place: its edge comes as a halo (parallel/halo.py)."""
    pairs = {(a.index, b.index) for g, row in enumerate(mesh.devices) for p, (x, y) in enumerate(zip(row, row[1:]))
             if mesh.owns(g, p) and mesh.owns(g, p + 1)
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
    P, H = _grid(mesh).shape["mode"], halo_width(op.offsets)
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
    for q, g, p, (s0, s1) in _owned(mesh, op.d):
        dev, c0 = mesh.devices[g][p], p * nl
        mine = bands[s0:s1, :, c0:c0 + width].contiguous().to(dev)
        side = torch.cuda.Stream(device=dev) if dev.type == "cuda" and comm == "gspmd" else None
        shards.append(Shard(dev, (s0, s1), (c0, c0 + nl), KroneckerSumOperator(mine, op.offsets, op.symmetric),
                            side, q))
    ring = _ring_launches(shards) if comm == "ring" and shards[0].device.type == "cuda" else ()
    return ShardedOperator(mesh, tuple(shards), op.offsets, op.symmetric, op.d, op.n, comm, ring)


def _ring_launches(shards: Sequence[Shard]) -> Tuple[Tuple[torch.device, Tuple[int, ...], RingLaunch], ...]:
    """Each card's (device, shard indices, RingLaunch of their bands)."""
    cards = {}
    for q, sh in enumerate(shards):
        cards.setdefault(sh.device, []).append(q)
    return tuple((dev, tuple(qs), RingLaunch([shards[q].op for q in qs])) for dev, qs in cards.items())


def shard_rhs(b: torch.Tensor, mesh: Mesh, d: Optional[int] = None,
              factor_axis: Optional[int] = None) -> List[torch.Tensor]:
    """b (d, …, n), or a rank-R block right-hand side (R, d, n), split as
    shard_operator splits the bands: one piece per shard, (d_f, …, n / n_mode)
    or (R, d_f, n / n_mode) on its device. With d given, a 3-D b whose axis
    1 has d entries is a block and splits over factor axis 1, so that
    ``shard_rhs(B, mesh, d)`` serves solve_block on any mesh; otherwise the
    factor axis is 0 (d defaults to b's axis 0). Pass factor_axis=0 for a
    (d, m, n) stack with m = d."""
    b = torch.as_tensor(b)
    if factor_axis is None:
        factor_axis = 1 if d is not None and b.dim() == 3 and b.shape[1] == d else 0
    return _split(b, _grid(mesh), d or b.shape[0], factor_axis)


def rhs_pieces(sop: ShardedOperator, b, block: bool = False) -> List[torch.Tensor]:
    """A solver's right-hand side over sop: b whole, (d, n) or, for a block,
    (R, d, n), is split as shard_rhs splits it; b given as pieces (a list)
    is checked against the shards: (d_f, n_local), or (R, d_f, n_local), on
    each shard's device."""
    lead = "R, " if block else ""
    if isinstance(b, (list, tuple)):
        ps = list(b)
        extra = tuple(ps[0].shape[:1]) if block and ps else ()
        want = [extra + (sh.factors[1] - sh.factors[0], sh.cols[1] - sh.cols[0]) for sh in sop.shards]
        got = [tuple(x.shape) for x in ps]
        if got != want or any(x.device != sh.device for x, sh in zip(ps, sop.shards)):
            hint = " (a block B (R, d, n): shard_rhs(B, mesh, d))" if block else ""
            raise ValueError(f"b's pieces must be ({lead}d_f, n_local) on their shards' devices, {want} on "
                             f"{[str(sh.device) for sh in sop.shards]}; got {got} on "
                             f"{[str(x.device) for x in ps]}{hint}")
        return ps
    b = torch.as_tensor(b, device=sop.device)
    fa = 1 if block else 0
    if b.dim() != 2 + fa or b.shape[fa] != sop.d or b.shape[-1] != sop.n:
        raise ValueError(f"b must be ({lead}d, n) = ({lead}{sop.d}, {sop.n}), got {tuple(b.shape)}")
    return _split(b, sop.mesh, sop.d, fa)


def shard_basis(U: torch.Tensor, mesh: Mesh, d: int) -> List[torch.Tensor]:
    """A deflation basis U (1 | d, n, m), n on axis 1, split as shard_rhs
    splits b: n over the mode shards and, for distinct factors (d, n, m), d
    over the factor groups; a shared U (1, n, m) goes to every group whole
    in its factor axis. One piece (1 | d_f, n / n_mode, m) per shard."""
    P = _grid(mesh).shape["mode"]
    n = U.shape[1]
    if n % P:
        raise ValueError(f"n={n} is not a multiple of the {P} mode shards")
    nl = n // P
    return [(U if U.shape[0] == 1 else U[s0:s1])[:, p * nl:(p + 1) * nl].contiguous().to(mesh.devices[g][p])
            for _, g, p, (s0, s1) in _owned(mesh, d)]


def allgather(mesh: Mesh, xs: Sequence[torch.Tensor], kind: str = "gather") -> List[torch.Tensor]:
    """Every shard's tensor, in shard order, from this process's xs (one per
    shard it owns): xs themselves on a one-process mesh; across processes
    all-gathered, each rank's stacked (one shape and dtype), so that every
    rank gets the same list. On gloo, which gathers host tensors only, CUDA
    tensors go through pinned host buffers; NCCL gathers them on the card.
    The received tensors land on xs[0]'s device; comm_stats counts them
    under kind."""
    if mesh.processes == 1:
        return list(xs)
    dev = xs[0].device
    stacked = torch.stack([x.to(dev) for x in xs])
    staged = dev.type == "cuda" and dist.get_backend() != "nccl"
    if staged:
        torch.cuda.current_stream(dev).synchronize()     # the exchange alone is timed
    t0 = time.perf_counter()
    if staged:
        send = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
        send.copy_(stacked)
        recv = [torch.empty_like(send, pin_memory=True) for _ in range(dist.get_world_size())]
        dist.all_gather(recv, send)
        recv = [t.to(dev, non_blocking=True) for t in recv]
    else:
        recv = [torch.empty_like(stacked) for _ in range(dist.get_world_size())]
        dist.all_gather(recv, stacked)
    nbytes = stacked.numel() * stacked.element_size()
    comm_stats.update({f"{kind}_calls": 1, f"{kind}_bytes": nbytes, f"{kind}_host_bytes": nbytes * staged * len(recv),
                       f"{kind}_s": time.perf_counter() - t0})
    return [x for t in recv for x in t.unbind(0)]


def gather(pieces: Sequence[torch.Tensor], mesh: Mesh, axis: int = -1, factor_axis: int = 0) -> torch.Tensor:
    """The inverse of the split: the pieces of each factor group joined along
    axis (the mode axis), the groups along factor_axis, on the lead device.
    Across processes the pieces are this rank's and are all-gathered first:
    every rank returns the whole."""
    pieces = allgather(mesh, pieces)
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
