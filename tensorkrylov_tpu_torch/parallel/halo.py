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
``halo_slabs`` joins the halos into each shard's slab ``[left halo | v |
right halo]``. A v may stack several vectors on a leading axis: the df64
recurrence exchanges its f32 pair (hi, lo) as one (2, d_f, n_local) tensor,
and ``triple_spmv_pairs_sharded`` runs the pair SpMV of ``ops/expansion.py``
on the slabs.

Across processes (``multihost.make_pod_mesh``) a rank holds its own shards
only. A neighbour in another process is never read in place: its H edge
columns come by ``send``/``recv`` (one ``batch_isend_irecv`` per exchange)
into this shard's halo buffer, and this shard's edges go to it. On NCCL the
edges travel card to card; on gloo, which sends host tensors only, a CUDA
edge is copied into a pinned host buffer, sent, received into another and
copied to the card (``comm_stats`` counts the calls, bytes and seconds). On
the ring route the kernel then reads that buffer as the neighbour's
``Source`` (base H on the left, 0 on the right): still one ring launch per
rank and card for all of its shards. Neighbours within the process are read
in place as before.

Layout contract: arrays are split on their last axis over the mode shards,
n % n_mode == 0, and a shard is at least H wide. The halos of one call are
overwritten by the next call on the same ShardedOperator.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops import expansion as ex
from ..ops.banded import spmv
from ..ops.ring_spmv import Source, ring_spmv_edge, ring_spmv_interior, ring_spmv_local
from ..types import KroneckerSumOperator
from .sharding import Mesh, ShardedOperator, comm_stats, gather, shard_operator, shard_rhs

__all__ = ["exchange_halos", "halo_slabs", "ring_sources", "spmv_halo_local", "spmv_sharded",
           "triple_spmv_pairs_sharded", "make_halo_spmv", "spmv_halo"]


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


def _neighbours(sop: ShardedOperator) -> List[Tuple[Optional[Tuple[str, int]], Optional[Tuple[str, int]]]]:
    """Each shard's (left, right) neighbour in its factor group's chain: None
    at a chain end, ('local', i) for this process's shard i, ('remote', q)
    for shard q of another process."""
    P = sop.n_mode
    at = {sh.index: i for i, sh in enumerate(sop.shards)}
    links = []
    for sh in sop.shards:
        p = sh.index % P
        pair = [None if not ok else ("local", at[q]) if q in at else ("remote", q)
                for q, ok in ((sh.index - 1, p > 0), (sh.index + 1, p < P - 1))]
        links.append(tuple(pair))
    return links


def _exchange_remote(sop: ShardedOperator, vs: Sequence[torch.Tensor],
                     halos: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """The edges of neighbours in other processes into this process's halo
    buffers, and its own edges to them, in one batch of sends and receives:
    a shard's first H columns are its left neighbour's right halo, its last
    H its right neighbour's left halo (the tag 2q + side names the receiving
    shard q and side). CUDA edges on gloo go through pinned host buffers."""
    H, P, mesh = sop.halo, sop.n_mode, sop.mesh
    sends, recvs = [], []
    for sh, v, (lh, rh), links in zip(sop.shards, vs, halos, _neighbours(sop)):
        for side, (link, buf) in enumerate(zip(links, (lh, rh))):
            if link is None or link[0] == "local":
                continue
            q, peer = link[1], mesh.owner(*divmod(link[1], P))
            sends.append((peer, 2 * q + 1 - side, v.narrow(-1, 0 if side == 0 else v.shape[-1] - H, H)))
            recvs.append((peer, 2 * sh.index + side, buf))
    if not recvs or H == 0:
        return
    dev = vs[0].device
    staged = dev.type == "cuda" and dist.get_backend() != "nccl"
    if staged:
        torch.cuda.current_stream(dev).synchronize()     # the exchange alone is timed
    t0 = time.perf_counter()
    if staged:
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t) for _, _, t in sends]
        into = [torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True) for _, _, buf in recvs]
    else:
        out, into = [t.contiguous() for _, _, t in sends], [buf for _, _, buf in recvs]
    ops = ([dist.P2POp(dist.isend, t, peer, tag=tag) for (peer, tag, _), t in zip(sends, out)]
           + [dist.P2POp(dist.irecv, t, peer, tag=tag) for (peer, tag, _), t in zip(recvs, into)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for (_, _, buf), t in zip(recvs, into):
            buf.copy_(t, non_blocking=True)
    nbytes = sum(t.numel() * t.element_size() for t in out)
    comm_stats.update(halo_calls=1, halo_bytes=nbytes, halo_host_bytes=2 * nbytes * staged,
                      halo_s=time.perf_counter() - t0)


def exchange_halos(sop: ShardedOperator, vs: Sequence[torch.Tensor]
                   ) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], List[Optional[torch.cuda.Event]]]:
    """Per shard (left halo, right halo), each (d_f, …, H): the last H columns
    of the left neighbour and the first H of the right one, zeros at the chain
    ends; and per shard the event after which its halos are complete on its
    side stream (None where the copies ran on the current stream: CPU shards
    and the ring route's CUDA shards, which have no side stream). A
    neighbour's edge from another process arrives on the current stream."""
    H = sop.halo
    halos = _halo_buffers(sop, vs)
    ready = ({sh.device: torch.cuda.current_stream(sh.device).record_event() for sh in sop.shards}
             if any(sh.side is not None for sh in sop.shards) else {})
    events = []
    for sh, (lh, rh), (left, right) in zip(sop.shards, halos, _neighbours(sop)):
        copies = []
        if H > 0 and left is not None and left[0] == "local":
            copies.append((lh, left[1], vs[left[1]].shape[-1] - H))
        if H > 0 and right is not None and right[0] == "local":
            copies.append((rh, right[1], 0))
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
    if sop.mesh.processes > 1:
        _exchange_remote(sop, vs, halos)
    return halos, events


def spmv_halo_local(op: KroneckerSumOperator, v: torch.Tensor, lhalo: torch.Tensor, rhalo: torch.Tensor) -> torch.Tensor:
    """Per-shard body in ``halo.py:51``'s order: the interior with zero-filled
    in-shard shifts, then the edge corrections one band at a time. It is the
    ring kernel (ops/ring_spmv.py) with the halo buffers as its sources on a
    CUDA shard, and its plain version on a CPU shard."""
    return ring_spmv_local(op, v, lhalo, rhalo)


def ring_sources(sop: ShardedOperator, vs: Sequence[torch.Tensor],
                 halos: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None
                 ) -> List[Tuple[Optional[Source], Optional[Source]]]:
    """Each shard's (left, right) source for the ring kernel: a neighbouring
    shard of this process is its own v, read in place (the left one's last H
    columns from base nl, the right one's first H from base 0); a neighbour
    in another process is this shard's halo buffer in halos, which
    _exchange_remote filled (base H on the left, 0 on the right); None at the
    two ends of each factor group's chain."""
    H = sop.halo
    out = []
    for i, links in enumerate(_neighbours(sop)):
        pair = []
        for side, link in enumerate(links):
            if link is None:
                pair.append(None)
            elif link[0] == "local":
                pair.append(Source(vs[link[1]], vs[link[1]].shape[-1] if side == 0 else 0))
            else:
                pair.append(Source(halos[i][side], H if side == 0 else 0))
        out.append(tuple(pair))
    return out


def _spmv_ring_cuda(sop: ShardedOperator, vs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One ring launch per card (sop.ring), with the neighbours' edges read
    in place, or from the halo buffers where they live in another process."""
    halos = None
    if sop.mesh.processes > 1:
        halos = _halo_buffers(sop, vs)
        _exchange_remote(sop, vs, halos)
    sources = ring_sources(sop, vs, halos)
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
    if sop.comm == "ring":
        halos, _ = exchange_halos(sop, vs)
        us = [ring_spmv_interior(sh.op, v) for sh, v in zip(sop.shards, vs)]
        return [ring_spmv_edge(sh.op, u, lh, rh) for sh, u, (lh, rh) in zip(sop.shards, us, halos)]
    out = []
    for sh, slab, v in zip(sop.shards, halo_slabs(sop, vs), vs):
        nl = v.shape[-1]
        with torch.cuda.device(sh.device) if sh.device.type == "cuda" else contextlib.nullcontext():
            out.append(spmv(sh.op, slab)[..., H:H + nl])
    return out


def halo_slabs(sop: ShardedOperator, vs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each shard's slab [left halo | v | right halo], (…, n_local + 2H) on
    its device, after exchange_halos: the halos of the chain ends are zeros.
    The current stream of each shard waits for its halos' event first."""
    halos, events = exchange_halos(sop, vs)
    slabs = []
    for sh, v, (lh, rh), ev in zip(sop.shards, vs, halos, events):
        if ev is not None:
            torch.cuda.current_stream(sh.device).wait_event(ev)
        slabs.append(torch.cat([lh, v, rh], dim=-1))
    return slabs


def triple_spmv_pairs_sharded(sop: ShardedOperator, bands: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                              vh: Sequence[torch.Tensor], vl: Sequence[torch.Tensor]) -> List[ex.Triple]:
    """ops/expansion.triple_spmv_pairs on every shard (comm='gspmd'): the
    pair v = (vh, vl) exchanged as one stacked tensor, the SpMV on each
    shard's slab with its padded pair bands ((d_f, nb, n_local + 2H) hi and
    lo of the shard's gspmd bands), the interior kept. Every output takes the
    same products in the same band order as on the whole row, so the result
    is bit-equal to the unsharded pair SpMV."""
    H = sop.halo
    out = []
    for (bh, bl), slab, v in zip(bands, halo_slabs(sop, [torch.stack([h, l]) for h, l in zip(vh, vl)]), vh):
        nl = v.shape[-1]
        z = ex.triple_spmv_pairs(bh, bl, sop.offsets, slab[0], slab[1])
        out.append(ex.Triple(*(t[..., H:H + nl] for t in z)))
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
        return gather(spmv_sharded(cache["sop"], shard_rhs(v, mesh, bands.shape[0], factor_axis=0)), mesh)

    return fn


def spmv_halo(op: KroneckerSumOperator, v: torch.Tensor, mesh: Mesh, comm: str = "ring") -> torch.Tensor:
    """One-shot convenience wrapper around make_halo_spmv."""
    return make_halo_spmv(mesh, op.offsets, comm)(op.bands, v)
