"""m dependent banded applies u ← scale·(A·u) per factor: counterpart of
``tensorkrylov_tpu/ops/pallas/resident_spmv.py``.

``spmv_multi_apply`` launches the CUDA kernel ``csrc/resident_spmv.cu`` (the
port of the Pallas kernel ``_kernel``) for tensors on a CUDA device, and
computes its plain PyTorch version ``spmv_multi_apply_reference`` for tensors
on the CPU. On any other device it raises.

The TPU kernel keeps one factor's bands and a ping-pong vector in VMEM for all
m applies. The CUDA kernel blocks in time instead: each thread block advances
a tile of T outputs M applies in shared memory, recomputing an M·H halo on
each side, so one launch does M applies and ⌈m/M⌉ launches do m
(``resident_spmv_plan`` gives M and T). The centred band sets -1..1 and -2..2
have instantiations of their own, which keep v and the bands in registers;
any other set takes the generic one, which keeps them in shared memory.
Unlike the JAX dispatcher, which falls back to its XLA scan on f64, on
n % 128, on offsets past 128 and on a VMEM budget, the kernel takes f32 and
f64, any n and any offsets whose span fits in shared memory, and raises on
the others (offsets so wide that not even one apply of one output fits).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..types import KroneckerSumOperator
from . import _build
from .banded import spmv_reference

__all__ = ["spmv_multi_apply", "spmv_multi_apply_reference", "resident_spmv_plan"]


def _rounded(scale, dtype) -> float:
    """scale rounded to dtype, as the Pallas kernel's weak-typed ``acc * scale``
    and the XLA scan's ``jnp.asarray(scale, v.dtype)`` round it."""
    return float(torch.tensor(float(scale), dtype=dtype))


def _halo(op: KroneckerSumOperator) -> int:
    return max((abs(o) for o in op.offsets), default=0)


def _centred(op: KroneckerSumOperator) -> bool:
    """The offsets are -H..H in order: the kernel's instantiations for 3 and 5 bands."""
    H = _halo(op)
    return tuple(op.offsets) == tuple(range(-H, H + 1))


def spmv_multi_apply_reference(op: KroneckerSumOperator, v: torch.Tensor, m: int, scale: float = 1.0) -> torch.Tensor:
    """Plain version, the counterpart of ``spmv_multi_apply_xla``: m calls of
    ``spmv_reference``, each product times scale rounded to v's dtype."""
    c = _rounded(scale, v.dtype)
    x = v.clone()
    for _ in range(m):
        x = spmv_reference(op, x) * c
    return x


def resident_spmv_plan(op: KroneckerSumOperator) -> Tuple[int, int]:
    """(M, T) of the kernel on the operator's CUDA device for this operator's
    offsets and dtype: applies per launch and outputs per tile at M applies (a
    launch of a < M applies takes a tile of T + 2·(M − a)·H)."""
    lib = _build.kernels()
    plan = (ctypes.c_int64 * 2)()
    err = lib.tk_resident_spmv_plan(op.device.index or 0, len(op.offsets), _halo(op), op.bands.element_size(),
                                    _centred(op), plan)
    if err != 0:
        raise ValueError(f"resident SpMV kernel cannot take {len(op.offsets)} bands of half-width {_halo(op)} "
                         f"in {op.dtype} (cudaError_t {err})")
    return int(plan[0]), int(plan[1])


def _multi_apply_cuda(op: KroneckerSumOperator, v: torch.Tensor, m: int, scale: float) -> torch.Tensor:
    bands = op.bands
    d, nb, n = bands.shape
    if bands.device != v.device:
        raise ValueError(f"bands on {bands.device} but v on {v.device}")
    if v.dtype != bands.dtype or v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"resident SpMV kernel takes f32 or f64 bands and v of one dtype, got {bands.dtype}, {v.dtype}")
    if tuple(v.shape) != (d, n):
        raise ValueError(f"v must be (d, n) = ({d}, {n}), got {tuple(v.shape)}")
    if not (bands.is_contiguous() and v.is_contiguous()):
        raise ValueError("resident SpMV kernel takes contiguous bands and v")
    if m < 0 or d > 65535:
        raise ValueError(f"resident SpMV kernel takes m >= 0 and at most 65535 factors, got m={m}, d={d}")
    if m == 0:
        return v.clone()
    with torch.cuda.device(v.device):
        M, T = resident_spmv_plan(op)
        lib = _build.kernels()
        fn = lib.tk_resident_spmv_f64 if v.dtype == torch.float64 else lib.tk_resident_spmv_f32
        c = _rounded(scale, v.dtype)
        H, centred = _halo(op), _centred(op)
        bufs = (torch.empty_like(v), torch.empty_like(v))
        src, done, launch = v, 0, 0
        while done < m:
            applies = min(M, m - done)
            dst = bufs[launch % 2]
            tile = T + 2 * (M - applies) * H  # fewer applies leave room for a wider tile
            err = fn(bands.data_ptr(), op.offsets_tensor.data_ptr(), src.data_ptr(), dst.data_ptr(),
                     d, nb, n, H, applies, tile, centred, c, _build.stream_of(v))
            _build.check(err, "resident_spmv")
            _build.launches["resident_spmv"] += 1
            src, done, launch = dst, done + applies, launch + 1
    return src


def spmv_multi_apply(op: KroneckerSumOperator, v: torch.Tensor, m: int, scale: float = 1.0) -> torch.Tensor:
    """u ← scaleᵐ·Aᵐ v for all d factors at once.

    Args:
      op: operator with bands (d, nb, n).
      v: (d, n).
      m: number of dependent applies (m = 0 returns a copy of v).
      scale: multiplies each apply's product, after rounding to v's dtype.

    Returns: (d, n). A CUDA tensor goes through the CUDA kernel (⌈m/M⌉
    launches); a CPU tensor through spmv_multi_apply_reference.
    """
    if v.device.type == "cuda":
        return _multi_apply_cuda(op, v, m, scale)
    if v.device.type == "cpu":
        return spmv_multi_apply_reference(op, v, m, scale)
    raise ValueError(f"spmv_multi_apply runs on cuda or cpu tensors, got {v.device}")
