"""Fused plain-Lanczos recurrence core: counterpart of
``tensorkrylov_tpu/ops/pallas/fused_lanczos.py:fused_lanczos_core``.

``fused_lanczos_core`` launches the CUDA kernels of ``csrc/fused_lanczos.cu``
(the port of the Pallas kernels ``_k1``/``_k2``) for tensors on a CUDA device,
in f32 or f64, and computes its plain PyTorch version
``fused_lanczos_core_reference`` for tensors on the CPU. On any other device
it raises. Unlike the TPU kernel it has no tile argument and no halo limit.

Both take the α, β² and ⟨u, b⟩ sums in the kernel's fixed two-stage order
(``fixed_order_sum``), so the two agree bit for bit. The order matters: a
Lanczos recurrence without reorthogonalization amplifies a change in the
rounding of these sums by about 2.6× per step (see
``tests/test_torch_solve.py::test_fused_trace_depends_on_sum_order``).
"""
from __future__ import annotations

import torch

from ..types import KroneckerSumOperator
from . import _build
from .banded import spmv_reference

__all__ = ["fused_lanczos_core", "fused_lanczos_core_reference", "fixed_order_sum"]

BLOCK = 256  # elements of a row per block of csrc/fused_lanczos.cu (its kThreads)


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
    if d > 65535:
        raise ValueError(f"fused Lanczos kernel takes at most 65535 factors, got {d}")
    lib = _build.kernels()
    if lib.tk_fused_lanczos_block_elems() != BLOCK:
        raise RuntimeError("csrc/fused_lanczos.cu and fused_lanczos.BLOCK disagree on the block size")
    n_blocks = -(-n // BLOCK)
    u = torch.empty((d, n), dtype=dtype, device=bands.device)
    partials = torch.empty((3, d, n_blocks), dtype=dtype, device=bands.device)
    sums = torch.empty((3, d), dtype=dtype, device=bands.device)
    fn = lib.tk_fused_lanczos_f64 if dtype == torch.float64 else lib.tk_fused_lanczos_f32
    err = fn(bands.data_ptr(), op.offsets_tensor.data_ptr(), v_prev.data_ptr(), v_pprev.data_ptr(),
             beta.data_ptr(), b.data_ptr(), u.data_ptr(), partials.data_ptr(), sums.data_ptr(),
             d, nb, n, _build.stream_of(u))
    _build.check(err, "fused_lanczos")
    _build.launches["fused_lanczos"] += 1
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
