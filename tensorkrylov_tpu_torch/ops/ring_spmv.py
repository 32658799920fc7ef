"""Per-shard banded SpMV of the mode-sharded solve: counterpart of
``tensorkrylov_tpu/ops/pallas/ring_spmv.py``.

One shard holds columns [c0, c0 + nl) of every factor of its group: bands
``(d_f, nb, nl)`` and v ``(d_f, nl)`` or ``(d_f, m, nl)``. Its SpMV needs the
H = max |offset| columns on each side. On CUDA shards the kernel
``csrc/ring_spmv.cu`` reads them in place: a ``RingLaunch`` launches it once
for all the shards of one card, each with a left and a right ``Source`` (the
neighbouring shard's own v, or a halo buffer that holds its edge; None at a
chain end). ``ring_spmv_local`` is one shard with halo buffers
``(d_f, [m,] H)`` as its sources: the same kernel, one shard. On the CPU
``ring_spmv_local`` computes the plain version ``ring_spmv_reference``, whose
two halves ``ring_spmv_interior`` and ``ring_spmv_edge`` are the CPU route of
``parallel/halo.py``; on any other device it raises.

Every version sums in ``parallel/halo.py``'s order: the interior terms in band
order, out-of-shard terms as band·0, then each edge correction added to the
result in band order. The TPU kernel sums one side's corrections before adding
them, which differs in rounding for two or more offsets on one side. Its
nl % 128 == 0 and H ≤ 128 rules have no counterpart here: any nl ≥ H.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..types import KroneckerSumOperator
from . import _build

__all__ = ["Source", "RingLaunch", "halo_width", "ring_spmv_reference", "ring_spmv_interior", "ring_spmv_edge",
           "ring_spmv_local", "make_ring_spmv"]


class Source(NamedTuple):
    """Where a shard reads a neighbour's edge columns: element (row, c) is
    ``tensor.view(rows, -1)[row, base + c]``, c in [−H, 0) on the left and
    [0, H) on the right. The neighbour's v: base nl on the left, 0 on the
    right; a halo buffer (…, H): base H on the left, 0 on the right."""

    tensor: torch.Tensor
    base: int


def halo_width(offsets: Tuple[int, ...]) -> int:
    """H = max |offset|: the columns a shard needs from each neighbour."""
    return max((abs(o) for o in offsets), default=0)


def _band(bands: torch.Tensor, b: int, v: torch.Tensor) -> torch.Tensor:
    return bands[:, b] if v.dim() == 2 else bands[:, b, None, :]


def _device_type(v: torch.Tensor) -> str:
    if v.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ring_spmv runs on cuda or cpu tensors, got {v.device}")
    return v.device.type


def ring_spmv_interior(op: KroneckerSumOperator, v: torch.Tensor) -> torch.Tensor:
    """The plain version's first half: in-shard terms in band order,
    zero-filled shifts (the CPU route of parallel/halo.py)."""
    nl = v.shape[-1]
    u = None
    for b, off in enumerate(op.offsets):
        if off == 0:
            sl = v
        else:
            sl = torch.zeros_like(v)
            if off > 0:
                sl[..., :nl - off] = v[..., off:]
            else:
                sl[..., -off:] = v[..., :nl + off]
        term = _band(op.bands, b, v) * sl
        u = term if u is None else u + term
    return u


def ring_spmv_edge(op: KroneckerSumOperator, u: torch.Tensor, lhalo: torch.Tensor, rhalo: torch.Tensor) -> torch.Tensor:
    """The plain version's second half: the edge corrections added to u in
    place, one band at a time; returns u."""
    H, nl = halo_width(op.offsets), u.shape[-1]
    for b, off in enumerate(op.offsets):
        bb = _band(op.bands, b, u)
        if off > 0:
            u[..., nl - off:] += bb[..., nl - off:] * rhalo[..., :off]
        elif off < 0:
            u[..., :-off] += bb[..., :-off] * lhalo[..., H + off:]
    return u


def ring_spmv_reference(op: KroneckerSumOperator, v: torch.Tensor, lhalo: torch.Tensor,
                        rhalo: torch.Tensor) -> torch.Tensor:
    """Plain version on one shard: op holds the shard's bands (d_f, nb, nl),
    v is (d_f, nl) or (d_f, m, nl), lhalo/rhalo (…, H) the neighbours' edges.
    The interior with zero-filled in-shard shifts, then the edge corrections
    one band at a time, each product and sum rounded on its own."""
    return ring_spmv_edge(op, ring_spmv_interior(op, v), lhalo, rhalo)


@functools.lru_cache(maxsize=None)
def _table_type(words: int):
    return ctypes.c_int64 * words


def _source(src: Optional[Source], v: torch.Tensor, H: int, left: bool, checked: set) -> Tuple[int, int, int]:
    """(pointer, row stride, column base) of a source, (0, 0, 0) for None.
    A tensor in ``checked`` (one of the launch's own inputs) already has the
    launch's device, dtype, rows and layout."""
    if src is None:
        return 0, 0, 0
    t, base = src
    width = t.shape[-1]
    if id(t) not in checked and (t.device.type != "cuda" or t.dtype != v.dtype or t.shape[:-1] != v.shape[:-1]
                                 or not t.is_contiguous()):
        raise ValueError(f"a source must be a contiguous {v.dtype} CUDA tensor of rows {tuple(v.shape[:-1])}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (H <= base <= width if left else 0 <= base <= width - H):
        raise ValueError(f"a {'left' if left else 'right'} source needs H={H} columns "
                         f"{'before' if left else 'from'} its base; got width {width}, base {base}")
    return t.data_ptr(), width, base


class RingLaunch:
    """The ring kernel for the shards of one card: ``RingLaunch(ops)`` checks
    the shards' bands (one CUDA device, f32 or f64, one shape (d_f, nb, nl),
    one set of offsets, contiguous) once, and each call
    ``launch(vs, lefts, rights)`` checks its inputs and launches. Shard q has
    input vs[q] (d_f, [m,] nl) and reads the columns beyond its edges from
    lefts[q] and rights[q] (None: zeros, a chain end). One kernel launch on
    the card's current stream for up to 8 shards, each counted in
    ``_build.launches["ring_spmv"]``. It reads the sources in place, so
    whatever wrote them must be ordered before it (on the same stream, or by
    an event across cards). The results are views of one allocation."""

    def __init__(self, ops: Sequence[KroneckerSumOperator]):
        bands = ops[0].bands
        self.device, self.dtype, self.shape, self.offsets = bands.device, bands.dtype, bands.shape, ops[0].offsets
        if self.device.type != "cuda":
            raise ValueError(f"the ring kernel takes CUDA shards, got {self.device}; the plain version is "
                             f"ring_spmv_reference")
        if self.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"ring SpMV kernel takes f32 or f64, got {self.dtype}")
        for op in ops:
            if op.bands.device != self.device or op.bands.dtype != self.dtype:
                raise TypeError(f"one launch takes bands of one dtype on one device, got {op.bands.dtype} on "
                                f"{op.bands.device}; want {self.dtype} on {self.device}")
            if op.bands.shape != self.shape or op.offsets != self.offsets or not op.bands.is_contiguous():
                raise ValueError(f"every shard of a launch has contiguous bands {tuple(self.shape)} with offsets "
                                 f"{self.offsets}, got {tuple(op.bands.shape)} with {op.offsets}")
        self.H = halo_width(self.offsets)
        if self.shape[2] < self.H:
            raise ValueError(f"shard width {self.shape[2]} is below the halo width {self.H}")
        self.ops = tuple(ops)  # keeps the bands alive while their pointers are in use
        self.bands = [op.bands.data_ptr() for op in ops]

    def __call__(self, vs: Sequence[torch.Tensor], lefts: Sequence[Optional[Source]],
                 rights: Sequence[Optional[Source]]) -> List[torch.Tensor]:
        d, nb, nl = self.shape
        dev, dtype, H = self.device, self.dtype, self.H
        shape = vs[0].shape
        if len(vs) != len(self.bands) or len(shape) not in (2, 3) or shape[0] != d or shape[-1] != nl:
            raise ValueError(f"{len(self.bands)} inputs (d, nl) or (d, m, nl) with d={d}, nl={nl}; got "
                             f"{[tuple(v.shape) for v in vs]}")
        for v in vs:
            if v.dtype != dtype:
                raise TypeError(f"ring SpMV kernel takes v of the bands' dtype {dtype}, got {v.dtype}")
            if v.device != dev or v.shape != shape or not v.is_contiguous():
                raise ValueError(f"every v of a launch is contiguous {tuple(shape)} on {dev}, got "
                                 f"{tuple(v.shape)} on {v.device}")
        out = torch.empty((len(vs),) + tuple(shape), dtype=dtype, device=dev)
        base, step = out.data_ptr(), vs[0].numel() * vs[0].element_size()
        checked = {id(v) for v in vs}
        packed = []
        for q, (v, left, right) in enumerate(zip(vs, lefts, rights)):
            packed += [self.bands[q], v.data_ptr(), base + q * step, *_source(left, v, H, True, checked),
                       *_source(right, v, H, False, checked)]
        lib = _build.kernels()
        fn = lib.tk_ring_spmv_f64 if dtype == torch.float64 else lib.tk_ring_spmv_f32
        cap = lib.tk_ring_spmv_max_shards()
        m = 1 if len(shape) == 2 else shape[1]
        offsets = self.ops[0].offsets_tensor.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            for q0 in range(0, len(vs), cap):
                count = min(cap, len(vs) - q0)
                table = _table_type(9 * count)(*packed[9 * q0:9 * (q0 + count)])
                _build.check(fn(table, count, offsets, d, nb, m, nl, H, stream), "ring_spmv")
                _build.launches["ring_spmv"] += 1
        return list(out.unbind(0))


def ring_spmv_local(op: KroneckerSumOperator, v: torch.Tensor, lhalo: torch.Tensor, rhalo: torch.Tensor) -> torch.Tensor:
    """One shard's SpMV with its neighbours' edges in halo buffers
    (…, H): on a CUDA tensor the ring kernel on this one shard, with the
    halos as its sources (one launch); on a CPU tensor ring_spmv_reference."""
    if _device_type(v) == "cpu":
        return ring_spmv_reference(op, v, lhalo, rhalo)
    H = halo_width(op.offsets)
    if lhalo.device != v.device or rhalo.device != v.device:
        raise ValueError(f"bands, v and halos must share one device, got {v.device}, {lhalo.device}, {rhalo.device}")
    if lhalo.shape[-1] != H or rhalo.shape[-1] != H:
        raise ValueError(f"halos must be H={H} wide, got {tuple(lhalo.shape)} and {tuple(rhalo.shape)}")
    return RingLaunch([op])([v], [Source(lhalo, H)], [Source(rhalo, 0)])[0]


def make_ring_spmv(mesh, offsets: Tuple[int, ...]):
    """fn(bands (d, nb, n), v (d, [m,] n)) → (d, [m,] n): the SpMV with bands
    and v split over the mesh's mode axis (and its factor axis when it divides
    d), by the ring route of parallel/halo.py, gathered on the lead device."""
    from ..parallel.halo import make_halo_spmv

    return make_halo_spmv(mesh, offsets, comm="ring")
