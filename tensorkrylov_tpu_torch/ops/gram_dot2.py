"""The compensated Gram of the device cross-check
(``utils/cp.cp_residual_cross_check_device``).

``gram_dot2(C)`` takes C (d, P, n) and returns G = C Cᵀ per mode as f64
pairs (hi, lo), each (d, P, P): each entry a compensated dot product (Ogita,
Rump and Oishi's Dot2, its sum a pairwise tree of TwoSums), so hi + lo
carries the entry to about eps²·log2(n) of Σ|c_i c_j| whatever n is, where an
f64 GEMM carries it to about √n·eps.

The tree: leaf k of entry (i, j) is TwoProduct(c_j[k], c_i[k]) = (p, e); at
each level a node is TwoSum(left.hi, right.hi) = (s, err) with lo =
(left.lo + right.lo) + err, a level with an odd count carrying its last node
against a (+0, +0) pad. ``gram_dot2_plain`` computes it as torch ops, one row
of C at a time (any device; the CPU path). On a CUDA tensor, f64 and
contiguous, ``csrc/gram_dot2.cu`` computes it in one launch over aligned
chunks of 2^levels leaves and a second over the chunk nodes
(``chunk_plan``): the same tree, so the same bits where no product or its
error term leaves f64's normal range (the kernel's note says why). Any other
CUDA tensor raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .expansion import two_prod, two_sum

__all__ = ["gram_dot2", "gram_dot2_plain", "chunk_plan", "LEVELS"]

LEVELS = 10       # the kernel's kLevels: a chunk holds at most 2^10 leaves


def chunk_plan(n: int) -> Tuple[int, int, int]:
    """The kernel's split of n leaves: (levels, n_chunks, levels2), chunks of
    2^levels leaves with levels = min(LEVELS, ⌈log2 n⌉) (no more levels than
    the plain tree has), n_chunks = ⌈n / 2^levels⌉ and levels2 =
    ⌈log2 n_chunks⌉ for the tree over the chunk nodes."""
    if n < 1:
        raise ValueError(f"gram_dot2 needs n >= 1, got {n}")
    levels = min(LEVELS, (n - 1).bit_length())
    n_chunks = -(-n // (1 << levels))
    return levels, n_chunks, (n_chunks - 1).bit_length()


def gram_dot2_plain(C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The module's (hi, lo) as torch ops on C's device: per row i, the
    TwoProducts of rows j >= i with it, then the tree level by level."""
    d, P, n = C.shape
    hi = torch.zeros((d, P, P), dtype=C.dtype, device=C.device)
    lo = torch.zeros_like(hi)
    for i in range(P):
        p, e = two_prod(C[:, i:, :], C[:, i:i + 1, :])                 # (d, P - i, n)
        while p.shape[-1] > 1:
            if p.shape[-1] % 2:
                p, e = (torch.nn.functional.pad(t, (0, 1)) for t in (p, e))
            s, err = two_sum(p[..., 0::2], p[..., 1::2])
            p, e = s, e[..., 0::2] + e[..., 1::2] + err
        hi[:, i, i:], lo[:, i, i:] = p[..., 0], e[..., 0]
        hi[:, i:, i], lo[:, i:, i] = p[..., 0], e[..., 0]
    return hi, lo


def gram_dot2(C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) (d, P, P) of C (d, P, n): the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if C.device.type == "cuda":
        return _gram_dot2_cuda(C)
    if C.device.type == "cpu":
        return gram_dot2_plain(C)
    raise ValueError(f"gram_dot2 runs on cuda or cpu tensors, got {C.device}")


def _gram_dot2_cuda(C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if C.dtype != torch.float64:
        raise TypeError(f"the gram_dot2 kernel takes float64, got {C.dtype}")
    if C.dim() != 3 or min(C.shape) < 1:
        raise ValueError(f"the gram_dot2 kernel takes C of shape (d, P, n), each >= 1, got {tuple(C.shape)}")
    if not C.is_contiguous():
        raise ValueError("the gram_dot2 kernel takes a contiguous C")
    d, P, n = C.shape
    levels, n_chunks, levels2 = chunk_plan(n)
    hi = torch.empty((d, P, P), dtype=torch.float64, device=C.device)
    lo = torch.empty_like(hi)
    hi_s = torch.empty((d, n_chunks, P * (P + 1) // 2), dtype=torch.float64, device=C.device)
    lo_s = torch.empty_like(hi_s)
    lib = _build.kernels()
    with torch.cuda.device(C.device):
        err = lib.tk_gram_dot2_f64(C.data_ptr(), d, P, n, levels, n_chunks, levels2, hi_s.data_ptr(),
                                   lo_s.data_ptr(), hi.data_ptr(), lo.data_ptr(), _build.stream_of(C))
    _build.check(err, "gram_dot2")
    _build.launches["gram_dot2"] += 1
    return hi, lo
