"""Fused plain-Lanczos recurrence core: counterpart of
``tensorkrylov_tpu/ops/pallas/fused_lanczos.py:fused_lanczos_core``.

``fused_lanczos_core`` launches the CUDA kernel of ``csrc/fused_lanczos.cu``
(the port of the Pallas kernels ``_k1``/``_k2``) for tensors on a CUDA device,
in f32 or f64, and computes its plain PyTorch version
``fused_lanczos_core_reference`` for tensors on the CPU. On any other device
it raises. Unlike the TPU kernel it has no tile argument and no halo limit.

The kernel is one launch per call: one thread-block cluster of G blocks per
factor (``fused_lanczos_plan``), which keeps w on chip between α and u, in
shared memory where a block's part fits in ``W_SHARED_BYTES`` and in u's own
row otherwise. Both take the α, β² and ⟨u, b⟩ sums in the kernel's fixed
two-stage order (``fixed_order_sum``), so the two agree bit for bit at every G
and in both placements. The order matters: a Lanczos recurrence without
reorthogonalization amplifies a change in the rounding of these sums by about
2.6× per step (see
``tests/test_torch_solve.py::test_fused_trace_depends_on_sum_order``).
"""
from __future__ import annotations

import functools

import torch

from ..types import KroneckerSumOperator
from . import _build
from ._cluster import cluster_plan, device_index, max_active_clusters, sm_count as _sm_count
from .banded import spmv_reference

__all__ = ["fused_lanczos_core", "fused_lanczos_core_reference", "fixed_order_sum", "fused_lanczos_plan"]

BLOCK = 256  # elements of a chunk tree and second-stage slots of the kernels (tk_common.cuh: kChunk, kSlots)
W_SHARED_BYTES = 200 * 1024  # a block keeps its elements of w in shared memory when they fit in this


def _tree_sum(x):
    """Sum over the last axis, a power of two long, in the kernel's shared-memory
    tree: the upper half is added onto the lower half until one entry is left."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _blocks(x):
    """(..., m) → (..., ceil(m / BLOCK), BLOCK), zero-padded as the kernel's idle threads are."""
    return torch.nn.functional.pad(x, (0, -x.shape[-1] % BLOCK)).unflatten(-1, (-1, BLOCK))


def fixed_order_sum(x):
    """Σ over the last axis in the order of the kernel's two-stage reduction:
    each BLOCK-long chunk is tree-summed to a partial; thread t of the second
    stage adds partials t, t + BLOCK, … in turn, and the BLOCK thread results
    are tree-summed."""
    parts = _blocks(_tree_sum(_blocks(x)))     # (..., n_blocks padded / BLOCK, BLOCK)
    acc = torch.zeros_like(parts[..., 0, :])
    for j in range(parts.shape[-2]):
        acc = acc + parts[..., j, :]
    return _tree_sum(acc)


def fused_lanczos_core_reference(op: KroneckerSumOperator, v_prev, v_pprev, beta, b):
    """Plain version of the fused core, in the inputs' dtype."""
    w = spmv_reference(op, v_prev) - beta[:, None] * v_pprev
    alpha = fixed_order_sum(w * v_prev)
    u = w - alpha[:, None] * v_prev
    return u, alpha, fixed_order_sum(u * u), fixed_order_sum(u * b)


def _w_bytes(n: int, G: int, elt: int) -> int:
    """The dynamic shared memory of a launch: a block's ceil(ceil(n / BLOCK) / G)
    chunks of w where they fit in W_SHARED_BYTES, else 0 (w in u's row)."""
    chunks = -(-n // BLOCK)
    nbytes = -(-chunks // G) * BLOCK * elt
    return nbytes if nbytes <= W_SHARED_BYTES else 0


def _max_active_clusters(G: int, device: int, smem: int, elt: int) -> int:
    """How many clusters of G blocks of the elt-byte kernel, each with smem
    bytes of dynamic shared memory, the card holds at once; 0 when it cannot
    launch one."""
    return max_active_clusters("tk_fused_lanczos_max_clusters", device, G, smem, elt)


@functools.lru_cache(maxsize=None)
def _plan(d: int, n: int, elt: int, device: int, w_limit: int) -> int:
    """fused_lanczos_plan's G, kept per W_SHARED_BYTES (w_limit), which decides the placement."""
    return cluster_plan(d, -(-n // BLOCK), _sm_count(device),
                        lambda G: _max_active_clusters(G, device, _w_bytes(n, G, elt), elt))


def fused_lanczos_plan(d: int, n: int, dtype, device=None) -> int:
    """G, the blocks per factor of the kernel's cluster (``cluster_plan``
    with the kernel's occupancy at its w placement)."""
    return _plan(d, n, dtype.itemsize, device_index(device), W_SHARED_BYTES)


def _fused_cuda(op: KroneckerSumOperator, v_prev, v_pprev, beta, b):
    bands = op.bands
    d, nb, n = bands.shape
    dtype = bands.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused Lanczos kernel takes f32 or f64, got {dtype}")
    for name, t, shape in (("v_prev", v_prev, (d, n)), ("v_pprev", v_pprev, (d, n)),
                           ("beta", beta, (d,)), ("b", b, (d, n))):
        if t.device != bands.device or t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on {bands.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got {tuple(t.shape)}")
    if not bands.is_contiguous():
        raise ValueError("fused Lanczos kernel takes contiguous bands")
    dev = bands.device
    G = fused_lanczos_plan(d, n, dtype, dev)
    if d * G > 2**31 - 1:
        raise ValueError(f"fused Lanczos kernel takes fewer than 2**31 blocks, got d={d}, G={G}")
    lib = _build.kernels()
    if lib.tk_fused_lanczos_block_elems() != BLOCK:
        raise RuntimeError("csrc/fused_lanczos.cu and fused_lanczos.BLOCK disagree on the block size")
    u = torch.empty((d, n), dtype=dtype, device=dev)
    # the sums (3, d): alpha, beta^2, ub; then the chunk sums (d, 3, ceil(n / BLOCK))
    scratch = torch.empty(3 * d * (1 + -(-n // BLOCK)), dtype=dtype, device=dev)
    fn = lib.tk_fused_lanczos_f64 if dtype == torch.float64 else lib.tk_fused_lanczos_f32
    with torch.cuda.device(dev):
        err = fn(bands.data_ptr(), op.offsets_tensor.data_ptr(), v_prev.data_ptr(), v_pprev.data_ptr(),
                 beta.data_ptr(), b.data_ptr(), u.data_ptr(), scratch.data_ptr(), d, nb, n, G,
                 _w_bytes(n, G, u.element_size()) > 0, _build.stream_of(u))
    _build.check(err, "fused_lanczos")
    if d > 0 and n > 0:
        _build.launches["fused_lanczos"] += 1
    sums = scratch[:3 * d].view(3, d)
    return u, sums[0], sums[1], sums[2]


def fused_lanczos_core(op: KroneckerSumOperator, v_prev, v_pprev, beta, b):
    """One fused plain-Lanczos recurrence core for all d factors.

    Args:
      op: operator, bands (d, nb, n) in the compute dtype (f32 or f64).
      v_prev, v_pprev: (d, n) basis columns k-1 / k-2.
      beta: (d,) previous subdiagonal.
      b: (d, n) right-hand side factors.
      All in the bands' dtype.

    Returns (u, alpha, beta_sq, ub) in that dtype:
      u: (d, n) unnormalized new direction (after the alpha/beta subtraction),
      alpha = <A v_prev - beta v_pprev, v_prev>, beta_sq = ||u||^2, ub = <u, b>.
    """
    if v_prev.device.type == "cuda":
        return _fused_cuda(op, v_prev, v_pprev, beta, b)
    if v_prev.device.type == "cpu":
        return fused_lanczos_core_reference(op, v_prev, v_pprev, beta, b)
    raise ValueError(f"fused_lanczos_core runs on cuda or cpu tensors, got {v_prev.device}")
