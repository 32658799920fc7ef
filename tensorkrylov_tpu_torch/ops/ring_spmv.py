"""Per-shard banded SpMV of the mode-sharded solve: counterpart of
``tensorkrylov_tpu/ops/pallas/ring_spmv.py``.

One shard holds columns [c0, c0 + nl) of every factor of its group: bands
``(d_f, nb, nl)`` and v ``(d_f, nl)`` or ``(d_f, m, nl)``. Its SpMV needs the
H = max |offset| columns on each side, which ``parallel/halo.py`` copies from
the neighbouring shards into ``lhalo`` and ``rhalo`` ``(d_f, [m,] H)`` (zeros at
the two ends of the chain). The CUDA kernel ``csrc/ring_spmv.cu`` has two
entry points: ``ring_spmv_interior`` launches the interior at once on the
current stream, and ``ring_spmv_edge``, after the halo copy's event, adds the
edge corrections; ``parallel/halo.py`` launches every shard's interior before
any edge, so the interiors run while the halos are copied. ``ring_spmv_local``
is the two in turn. For tensors on the CPU they compute the plain PyTorch
version ``ring_spmv_reference``. On any other device they raise.

Both sum in ``parallel/halo.py``'s order: the interior terms in band order,
out-of-shard terms as band·0, then each edge correction added to the result
in band order. The TPU kernel sums one side's corrections before adding them,
which differs in rounding for two or more offsets on one side. Its
nl % 128 == 0 and H ≤ 128 rules have no counterpart here: any nl ≥ H.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..types import KroneckerSumOperator
from . import _build

__all__ = ["halo_width", "ring_spmv_reference", "ring_spmv_interior", "ring_spmv_edge", "ring_spmv_local",
           "make_ring_spmv"]


def halo_width(offsets: Tuple[int, ...]) -> int:
    """H = max |offset|: the columns a shard needs from each neighbour."""
    return max((abs(o) for o in offsets), default=0)


def _band(bands: torch.Tensor, b: int, v: torch.Tensor) -> torch.Tensor:
    return bands[:, b] if v.dim() == 2 else bands[:, b, None, :]


def _interior_reference(op: KroneckerSumOperator, v: torch.Tensor) -> torch.Tensor:
    """The interior: in-shard terms in band order, zero-filled shifts."""
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


def _edge_reference(op: KroneckerSumOperator, u: torch.Tensor, lhalo: torch.Tensor, rhalo: torch.Tensor) -> None:
    """The edge corrections added to u in place, one band at a time."""
    H, nl = halo_width(op.offsets), u.shape[-1]
    for b, off in enumerate(op.offsets):
        bb = _band(op.bands, b, u)
        if off > 0:
            u[..., nl - off:] += bb[..., nl - off:] * rhalo[..., :off]
        elif off < 0:
            u[..., :-off] += bb[..., :-off] * lhalo[..., H + off:]


def ring_spmv_reference(op: KroneckerSumOperator, v: torch.Tensor, lhalo: torch.Tensor,
                        rhalo: torch.Tensor) -> torch.Tensor:
    """Plain version on one shard: op holds the shard's bands (d_f, nb, nl),
    v is (d_f, nl) or (d_f, m, nl), lhalo/rhalo (…, H) the neighbours' edges.
    The interior with zero-filled in-shard shifts, then the edge corrections
    one band at a time, each product and sum rounded on its own."""
    u = _interior_reference(op, v)
    _edge_reference(op, u, lhalo, rhalo)
    return u


def _check_cuda(op: KroneckerSumOperator, v, halos=()) -> None:
    bands = op.bands
    d, nb, nl = bands.shape
    H = halo_width(op.offsets)
    if any(t.device != v.device for t in (bands,) + tuple(halos)):
        raise ValueError(f"bands, v and halos must share one device, got {bands.device}, {v.device}, "
                         f"{[str(t.device) for t in halos]}")
    if v.dtype not in (torch.float32, torch.float64) or any(t.dtype != v.dtype for t in (bands,) + tuple(halos)):
        raise TypeError(f"ring SpMV kernel takes f32 or f64 of one dtype, got {bands.dtype}, {v.dtype}, "
                        f"{[t.dtype for t in halos]}")
    if v.dim() not in (2, 3) or v.shape[0] != d or v.shape[-1] != nl:
        raise ValueError(f"v must be (d, nl) or (d, m, nl) with d={d}, nl={nl}; got {tuple(v.shape)}")
    halo_shape = tuple(v.shape[:-1]) + (H,)
    if any(tuple(t.shape) != halo_shape for t in halos):
        raise ValueError(f"halos must be {halo_shape}, got {[tuple(t.shape) for t in halos]}")
    if nl < H:
        raise ValueError(f"shard width {nl} is below the halo width {H}")
    if not all(t.is_contiguous() for t in (bands, v) + tuple(halos)):
        raise ValueError("ring SpMV kernel takes contiguous bands, v and halos")


def _dims(op: KroneckerSumOperator, v: torch.Tensor):
    d, nb, nl = op.bands.shape
    return d, nb, 1 if v.dim() == 2 else v.shape[1], nl


def _interior_cuda(op: KroneckerSumOperator, v: torch.Tensor) -> torch.Tensor:
    _check_cuda(op, v)
    out = torch.empty_like(v)
    lib = _build.kernels()
    interior = lib.tk_ring_spmv_interior_f64 if v.dtype == torch.float64 else lib.tk_ring_spmv_interior_f32
    with torch.cuda.device(v.device):
        _build.check(interior(op.bands.data_ptr(), op.offsets_tensor.data_ptr(), v.data_ptr(), out.data_ptr(),
                              *_dims(op, v), torch.cuda.current_stream(v.device).cuda_stream), "ring_spmv interior")
    return out


def _edge_cuda(op: KroneckerSumOperator, out, lhalo, rhalo, halo_ready) -> None:
    H = halo_width(op.offsets)
    _check_cuda(op, out, (lhalo, rhalo))
    if H == 0:
        return
    lib = _build.kernels()
    edge = lib.tk_ring_spmv_edge_f64 if out.dtype == torch.float64 else lib.tk_ring_spmv_edge_f32
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device)
        if halo_ready is not None:
            stream.wait_event(halo_ready)
        _build.check(edge(op.bands.data_ptr(), op.offsets_tensor.data_ptr(), lhalo.data_ptr(), rhalo.data_ptr(),
                          out.data_ptr(), *_dims(op, out), H, stream.cuda_stream), "ring_spmv edge")


def _device_type(v: torch.Tensor) -> str:
    if v.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ring_spmv runs on cuda or cpu tensors, got {v.device}")
    return v.device.type


def ring_spmv_interior(op: KroneckerSumOperator, v: torch.Tensor) -> torch.Tensor:
    """The interior of one shard's SpMV, launched at once on the current
    stream: the ring kernel's first entry point on a CUDA tensor, counted
    once in ``_build.launches["ring_spmv"]`` (the shard's edge launch is not
    counted again); the plain interior on a CPU tensor."""
    if _device_type(v) == "cpu":
        return _interior_reference(op, v)
    out = _interior_cuda(op, v)
    _build.launches["ring_spmv"] += 1
    return out


def ring_spmv_edge(op: KroneckerSumOperator, u: torch.Tensor, lhalo: torch.Tensor, rhalo: torch.Tensor,
                   halo_ready: Optional[torch.cuda.Event] = None) -> torch.Tensor:
    """Adds the edge corrections to ring_spmv_interior's u in place and
    returns it: on a CUDA tensor the ring kernel's second entry point, after
    the current stream waits for halo_ready (an event recorded after the halo
    copies) when it is given; the plain corrections on a CPU tensor."""
    if _device_type(u) == "cpu":
        _edge_reference(op, u, lhalo, rhalo)
    else:
        _edge_cuda(op, u, lhalo, rhalo, halo_ready)
    return u


def ring_spmv_local(op: KroneckerSumOperator, v: torch.Tensor, lhalo: torch.Tensor, rhalo: torch.Tensor,
                    halo_ready: Optional[torch.cuda.Event] = None) -> torch.Tensor:
    """One shard's SpMV: ring_spmv_interior, then ring_spmv_edge. A CUDA
    tensor goes through the ring kernel, counted once; a CPU tensor through
    ring_spmv_reference's two parts."""
    if _device_type(v) == "cuda":
        _check_cuda(op, v, (lhalo, rhalo))
    return ring_spmv_edge(op, ring_spmv_interior(op, v), lhalo, rhalo, halo_ready)


def make_ring_spmv(mesh, offsets: Tuple[int, ...]):
    """fn(bands (d, nb, n), v (d, [m,] n)) → (d, [m,] n): the SpMV with bands
    and v split over the mesh's mode axis (and its factor axis when it divides
    d), every shard through ring_spmv_local, gathered on the lead device."""
    from ..parallel.halo import make_halo_spmv

    return make_halo_spmv(mesh, offsets, comm="ring")
