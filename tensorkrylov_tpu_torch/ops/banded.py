"""Batched banded (DIA) SpMV: counterpart of ``tensorkrylov_tpu/ops/banded.py``.

``spmv`` launches the CUDA kernel ``csrc/banded_spmv.cu`` (the port of
``tensorkrylov_tpu/ops/pallas/banded_spmv.py:_kernel``) for tensors on a CUDA
device, and computes its plain PyTorch version ``spmv_reference`` for tensors
on the CPU. On any other device it raises.
"""
from __future__ import annotations

import torch

from ..types import KroneckerSumOperator
from . import _build

__all__ = ["spmv", "spmv_reference", "spmv_dense_oracle"]


def spmv_reference(op: KroneckerSumOperator, v: torch.Tensor) -> torch.Tensor:
    """Plain version: u[s] = A_s @ v[s] for all d factors, v (d, n) or (d, m, n).

    Terms are added in band order, each product rounded before its sum, as the
    kernel does; out-of-range columns contribute nothing.
    """
    n = op.n
    bands = op.bands if v.dim() == 2 else op.bands[:, :, None, :]
    u = torch.zeros_like(v)
    for b, off in enumerate(op.offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if lo < hi:
            u[..., lo:hi] += bands[:, b, ..., lo:hi] * v[..., lo + off:hi + off]
    return u


def _spmv_cuda(op: KroneckerSumOperator, v: torch.Tensor) -> torch.Tensor:
    bands = op.bands
    if bands.device != v.device:
        raise ValueError(f"bands on {bands.device} but v on {v.device}")
    if v.dtype != bands.dtype or v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spmv kernel takes f32 or f64 bands and v of one dtype, got {bands.dtype}, {v.dtype}")
    d, nb, n = bands.shape
    if v.dim() not in (2, 3) or v.shape[0] != d or v.shape[-1] != n:
        raise ValueError(f"v must be (d, n) or (d, m, n) with d={d}, n={n}; got {tuple(v.shape)}")
    if not (bands.is_contiguous() and v.is_contiguous()):
        raise ValueError("spmv kernel takes contiguous bands and v")
    m = 1 if v.dim() == 2 else v.shape[1]
    out = torch.empty_like(v)
    lib = _build.kernels()
    fn = lib.tk_banded_spmv_f64 if v.dtype == torch.float64 else lib.tk_banded_spmv_f32
    err = fn(bands.data_ptr(), op.offsets_tensor.data_ptr(), v.data_ptr(), out.data_ptr(),
             d, nb, m, n, _build.stream_of(v))
    _build.check(err, "banded_spmv")
    _build.launches["banded_spmv"] += 1
    return out


def spmv(op: KroneckerSumOperator, v: torch.Tensor) -> torch.Tensor:
    """u[s] = A_s @ v[s] for all d factors at once.

    Args:
      op: operator with bands (d, nb, n).
      v: (d, n) or (d, m, n): m extra vectors per factor share its bands.

    Returns: same shape as v. A CUDA tensor goes through the CUDA kernel; a
    CPU tensor through spmv_reference.
    """
    if v.device.type == "cuda":
        return _spmv_cuda(op, v)
    if v.device.type == "cpu":
        return spmv_reference(op, v)
    raise ValueError(f"spmv runs on cuda or cpu tensors, got {v.device}")


def spmv_dense_oracle(dense_factors: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reference oracle: (d, n, n) @ (d, n) (tests only)."""
    return torch.einsum("dij,dj->di", dense_factors, v)
