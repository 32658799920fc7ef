"""Krylov vectors split into shard pieces: the psum/scatter pair and the
SpMV over pieces. The JAX package has no such module: GSPMD partitions its
steps. Here the partition is written out, once, and every Krylov step of the
port (``ops/orth.py:lanczos_step`` and ``arnoldi_step``,
``deflate_light.py:_step``, ``df64_core.py:_df64_step``) is written over a
list of pieces with these helpers.

A piece is one shard's slab ``(…, d_f, n_local)`` on its device; the k-sized
values (H, b̃, β, the recorded coefficients) live on the lead device. Every
n-sized dot is a partial sum on its piece; the partials go to the lead device
and are summed there in shard order (``psum``: the JAX package's collective),
and what the pieces need of the result goes back to them (``scatter``).

Across processes (``multihost.make_pod_mesh``) a rank holds the pieces of
the shards it owns. ``psum`` all-gathers every shard's partial and adds them
on every rank in the same shard order, never by an all-reduce, whose order
is the backend's: the k-sized values are then the same bits on every rank
and the same as one controller's on the same layout, and every branch on
them (a convergence test, the auto reorthogonalization's probe, a lucky
breakdown) goes the same way on every rank, which keeps their collectives in
step. ``whole`` all-gathers the pieces, so every rank returns the same x.

An unsharded solve is the one-piece case: its operator is a
``KroneckerSumOperator``, its vectors are plain tensors, ``psum`` returns
the one partial and ``scatter`` the tensor itself, so the steps run the same
operations on the same tensors as before the pieces existed, bit for bit.
A list of tensors is pieces; anything else is one piece.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..ops.banded import spmv
from .halo import spmv_sharded
from .sharding import ShardedOperator, allgather, gather

__all__ = ["pieces", "like", "psum", "scatter", "norms", "spmv_pieces", "piece_ranges", "whole"]


def pieces(x) -> list:
    """x's pieces: x itself when it is a list, else [x]."""
    return x if isinstance(x, list) else [x]


def like(x, ps: list):
    """ps in x's form: the list when x is pieces, else its one piece."""
    return ps if isinstance(x, list) else ps[0]


def psum(op, partials: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-piece partial sums (d_f, …) → (d, …) on the lead device: the mode
    shards of each factor group summed in shard order, the groups stacked in
    factor order (across processes, every shard's partial all-gathered
    first). One piece: its partial."""
    if not isinstance(op, ShardedOperator):
        return partials[0]
    P, lead = op.n_mode, op.device
    partials = allgather(op.mesh, partials, "psum")
    rows = []
    for g in range(len(partials) // P):
        acc = partials[g * P].to(lead)
        for x in partials[g * P + 1:(g + 1) * P]:
            acc = acc + x.to(lead)
        rows.append(acc)
    return rows[0] if len(rows) == 1 else torch.cat(rows)


def scatter(op, t: torch.Tensor) -> List[torch.Tensor]:
    """A (d, …) tensor on the lead device → each piece's factor rows on its
    device (a view where the device is the lead's). One piece: [t]."""
    if not isinstance(op, ShardedOperator):
        return [t]
    return [t[sh.factors[0]:sh.factors[1]].to(sh.device) for sh in op.shards]


def norms(op, xs: Sequence[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """The vector norms along dim (the n axis) over pieces, on the lead
    device: torch.linalg.vector_norm of one piece; the square root of the
    psum of the pieces' sums of squares for several (a rank's one piece of
    a layout across processes is one of several)."""
    if len(xs) == 1 and not (isinstance(op, ShardedOperator) and op.n_shards > 1):
        return torch.linalg.vector_norm(xs[0], dim=dim)
    return torch.sqrt(psum(op, [torch.sum(x * x, dim=dim) for x in xs]))


def spmv_pieces(op, vs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """u = A v on every piece: ops/banded.spmv for one piece,
    parallel/halo.spmv_sharded (op.comm's route) for several."""
    if not isinstance(op, ShardedOperator):
        return [spmv(op, vs[0])]
    return spmv_sharded(op, vs)


def piece_ranges(op, V) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Each piece's (columns [c0, c1), factors [s0, s1)) of the whole; one
    piece V (…, d, n) is all of it."""
    if not isinstance(op, ShardedOperator):
        return [((0, V[0].shape[-1]), (0, V[0].shape[-2]))]
    return [(sh.cols, sh.factors) for sh in op.shards]


def whole(op, x, axis: int = -1, factor_axis: int = 0) -> torch.Tensor:
    """x whole on the lead device: pieces gathered along axis (the mode axis)
    and factor_axis (across processes, on every rank); one piece as it is."""
    if not isinstance(x, list):
        return x
    return gather(x, op.mesh, axis=axis, factor_axis=factor_axis)
