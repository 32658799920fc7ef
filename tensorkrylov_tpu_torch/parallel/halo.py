"""Halo exchange and the sharded SpMV: counterpart of
``tensorkrylov_tpu/parallel/halo.py``.

Each shard owns a contiguous slice of every factor's length-n axis. Its SpMV
needs the H = max |offset| edge columns of its two neighbours in the chain
(zeros at the two ends, as ``halo.py:46-47``, not wrapped data).

On CUDA shards the ring route exchanges nothing: the ring kernel reads the
neighbours' edges in place from their v (``ring_sources``), one launch per
card for all of that card's shards. On one card that launch follows the
writes of the v pieces on the card's current stream, so stream order is all
the ordering it needs. Across cards (peer access, enabled by
``shard_operator``) the launch waits for one event per neighbouring card,
recorded after its v was written, and each neighbour's current stream then
waits for the reading card's event, so that its allocator cannot reuse a v
still being read (``record_stream`` cannot fence another card's stream).

``exchange_halos`` copies the edges into each shard's halo buffers, kept on
the ShardedOperator and reused by every call. The gspmd route uses it on a
side stream of the receiving device, after events that mark the senders' v as
written and the receiver's earlier reads of the buffers as queued; the CPU
route of 'ring' and the plain version on the card copy on the current stream.

Layout contract: arrays are split on their last axis over the mode shards,
n % n_mode == 0, and a shard is at least H wide. The halos of one call are
overwritten by the next call on the same ShardedOperator.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.banded import spmv
from ..ops.ring_spmv import Source, ring_spmv_edge, ring_spmv_interior, ring_spmv_local
from ..types import KroneckerSumOperator
from .sharding import Mesh, ShardedOperator, gather, shard_operator, shard_rhs

__all__ = ["exchange_halos", "ring_sources", "spmv_halo_local", "spmv_sharded", "make_halo_spmv", "spmv_halo"]


def _halo_buffers(sop: ShardedOperator, vs: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each shard's (left, right) halo buffers for v of this shape and dtype,
    made zero once: a chain end's buffer is never written and stays zero."""
    key = (tuple(vs[0].shape[:-1]), vs[0].dtype)
    bufs = sop.halo_buffers.get(key)
    if bufs is None:
        bufs = []
        for sh, v in zip(sop.shards, vs):
            pair = tuple(torch.zeros(tuple(v.shape[:-1]) + (sop.halo,), dtype=v.dtype, device=sh.device)
                         for _ in range(2))
            if sh.side is not None:
                # written on the side stream: the allocator must not reuse
                # them, once the operator is gone, before those copies end
                for t in pair:
                    t.record_stream(sh.side)
            bufs.append(pair)
        sop.halo_buffers[key] = bufs
    return bufs


def exchange_halos(sop: ShardedOperator, vs: Sequence[torch.Tensor]
                   ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], List[Optional[torch.cuda.Event]]]:
    """Per shard (left halo, right halo), each (d_f, …, H): the last H columns
    of the left neighbour and the first H of the right one, zeros at the chain
    ends; and per shard the event after which its halos are complete on its
    side stream (None where the copies ran on the current stream: CPU shards
    and the ring route's CUDA shards, which have no side stream)."""
    H, P = sop.halo, sop.n_mode
    halos = _halo_buffers(sop, vs)
    ready = ({sh.device: torch.cuda.current_stream(sh.device).record_event() for sh in sop.shards}
             if any(sh.side is not None for sh in sop.shards) else {})
    events = []
    for q, (sh, (lh, rh)) in enumerate(zip(sop.shards, halos)):
        p = q % P
        copies = [(lh, q - 1, vs[q - 1].shape[-1] - H)] if p > 0 else []
        if p < P - 1:
            copies.append((rh, q + 1, 0))
        if H == 0:
            copies = []
        if sh.side is None:
            for buf, src, start in copies:
                buf.copy_(vs[src].narrow(-1, start, H))
            events.append(None)
            continue
        # the copies wait for the senders' v and for this shard's earlier
        # reads of its buffers, both queued on the devices' current streams
        for dev in {sh.device} | {vs[src].device for _, src, _ in copies}:
            sh.side.wait_event(ready[dev])
        with torch.cuda.device(sh.device), torch.cuda.stream(sh.side):
            for buf, src, start in copies:
                buf.copy_(vs[src].narrow(-1, start, H))
        # the caching allocator must not hand out a sender's v while the side
        # stream reads it. A copy from another card runs on the sender's
        # current stream (PyTorch fences it with the side stream), so only a
        # sender on this card is read by the side stream.
        for _, src, _ in copies:
            if vs[src].device == sh.device:
                vs[src].record_stream(sh.side)
        events.append(sh.side.record_event())
    return halos, events


def spmv_halo_local(op: KroneckerSumOperator, v: torch.Tensor, lhalo: torch.Tensor, rhalo: torch.Tensor) -> torch.Tensor:
    """Per-shard body in ``halo.py:51``'s order: the interior with zero-filled
    in-shard shifts, then the edge corrections one band at a time. It is the
    ring kernel (ops/ring_spmv.py) with the halo buffers as its sources on a
    CUDA shard, and its plain version on a CPU shard."""
    return ring_spmv_local(op, v, lhalo, rhalo)


def ring_sources(sop: ShardedOperator, vs: Sequence[torch.Tensor]) -> List[Tuple[Optional[Source], Optional[Source]]]:
    """Each shard's (left, right) source for the ring kernel: the
    neighbouring shards' own v, read in place (the left one's last H columns
    from base nl, the right one's first H from base 0); None at the two ends
    of each factor group's chain."""
    P = sop.n_mode
    return [(Source(vs[q - 1], vs[q - 1].shape[-1]) if q % P > 0 else None,
             Source(vs[q + 1], 0) if q % P < P - 1 else None) for q in range(len(vs))]


def _spmv_ring_cuda(sop: ShardedOperator, vs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One ring launch per card (sop.ring), with the neighbours' edges read in place."""
    sources = ring_sources(sop, vs)
    if len(sop.ring) == 1:
        return sop.ring[0][2](vs, [s[0] for s in sources], [s[1] for s in sources])
    ready = {dev: torch.cuda.current_stream(dev).record_event() for dev, _, _ in sop.ring}
    out: List[Optional[torch.Tensor]] = [None] * len(vs)
    for dev, qs, launch in sop.ring:
        peers = {src.tensor.device for q in qs for src in sources[q] if src is not None} - {dev}
        stream = torch.cuda.current_stream(dev)
        for peer in peers:
            stream.wait_event(ready[peer])
        us = launch([vs[q] for q in qs], [sources[q][0] for q in qs], [sources[q][1] for q in qs])
        done = stream.record_event()
        for peer in peers:
            torch.cuda.current_stream(peer).wait_event(done)
        for q, u in zip(qs, us):
            out[q] = u
    return out


def spmv_sharded(sop: ShardedOperator, vs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """u = A v on every shard, v (d_f, nl) or (d_f, m, nl) per shard, by
    sop.comm: 'ring' is one ring kernel launch per card that reads the
    neighbours' edges in place (on CPU shards: the halo exchange, every
    shard's plain interior, then every edge); 'gspmd' runs the banded_spmv
    kernel on the slab [left halo | v | right halo] with the shard's padded
    bands and keeps the centre, whose sums follow the unsharded band order."""
    H = sop.halo
    if sop.ring:
        return _spmv_ring_cuda(sop, vs)
    halos, events = exchange_halos(sop, vs)
    if sop.comm == "ring":
        us = [ring_spmv_interior(sh.op, v) for sh, v in zip(sop.shards, vs)]
        return [ring_spmv_edge(sh.op, u, lh, rh) for sh, u, (lh, rh) in zip(sop.shards, us, halos)]
    out = []
    for sh, v, (lh, rh), ev in zip(sop.shards, vs, halos, events):
        if ev is not None:
            torch.cuda.current_stream(sh.device).wait_event(ev)
        nl = v.shape[-1]
        with torch.cuda.device(sh.device) if sh.device.type == "cuda" else contextlib.nullcontext():
            out.append(spmv(sh.op, torch.cat([lh, v, rh], dim=-1))[..., H:H + nl])
    return out


def make_halo_spmv(mesh: Mesh, offsets: Tuple[int, ...], comm: str = "ring"):
    """fn(bands (d, nb, n), v (d, [m,] n)) → (d, [m,] n): bands and v split
    over the mesh, spmv_sharded with the given comm, the result gathered on
    the lead device. The bands are split once and reused while fn is given
    the same bands tensor (which must not change in place)."""
    cache = {}

    def fn(bands: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if cache.get("bands") is not bands:
            cache.update(bands=bands, sop=shard_operator(KroneckerSumOperator(bands, tuple(offsets)), mesh, comm))
        return gather(spmv_sharded(cache["sop"], shard_rhs(v, mesh, bands.shape[0])), mesh)

    return fn


def spmv_halo(op: KroneckerSumOperator, v: torch.Tensor, mesh: Mesh, comm: str = "ring") -> torch.Tensor:
    """One-shot convenience wrapper around make_halo_spmv."""
    return make_halo_spmv(mesh, op.offsets, comm)(op.bands, v)
