"""S complete plain-Lanczos steps per call: counterpart of
``tensorkrylov_tpu/ops/pallas/resident_lanczos.py``.

``lanczos_resident_steps`` launches the CUDA kernel ``csrc/resident_lanczos.cu``
(the port of the Pallas kernel ``_kernel``) for tensors on a CUDA device, and
computes its plain PyTorch version ``lanczos_resident_steps_reference`` for
tensors on the CPU. On any other device it raises.

Per step, for all d factors: u = A·vp − β·vpp, α = Σ u·vp, u −= α·vp,
β' = √Σu², v = u·(1/β'). When β' ≤ 1e-30 the column is zero and β' is
recorded as 0, which freezes the recurrence. There is no lucky-breakdown
restart and no reorthogonalization (unlike ``ops/orth.py:lanczos_step``).

Both versions take the sums in ``fixed_order_sum``'s order, take β' with a
correctly rounded square root and round every product and sum on its own, so
they agree bit for bit: without reorthogonalization the recurrence amplifies
a rounding difference about 2.6× per step. The kernel takes f32 only, as the
TPU kernel does; unlike it, any n, any offsets and any S in one launch.

The kernel spreads each factor over a thread-block cluster of G blocks;
``resident_lanczos_plan(d, n, device)`` picks G from the card's SM count and
how many clusters of each size it holds at once. Every G gives the same bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..types import KroneckerSumOperator
from . import _build
from ._cluster import cluster_plan, device_index, max_active_clusters, sm_count as _sm_count
from .banded import spmv_reference
from .fused_lanczos import BLOCK, fixed_order_sum
from .orth import _sqrt_rn

__all__ = [
    "ResidentSteps",
    "lanczos_resident_steps",
    "lanczos_resident_steps_reference",
    "lanczos_resident_supported",
    "resident_lanczos_plan",
]

FREEZE = 1e-30  # β' at or below this writes a zero column and records β' = 0
U_SHARED_BYTES = 200 * 1024  # a block keeps its elements of u in shared memory when they fit in this


class ResidentSteps(NamedTuple):
    """What S resident steps return, all f32."""

    V: torch.Tensor       # (S, d, n) the new basis columns
    alpha: torch.Tensor   # (d, S)
    beta: torch.Tensor    # (d, S) the subdiagonal of each step (0 once frozen)
    vp: torch.Tensor      # (d, n) the last column: the next call's vp
    vpp: torch.Tensor     # (d, n) the one before: the next call's vpp
    beta_last: torch.Tensor  # (d,) the next call's β


def lanczos_resident_supported(op: KroneckerSumOperator) -> bool:
    """The kernel takes f32 bands. It masks its loads, so unlike the TPU
    kernel it takes any n and any offsets, and it has no memory budget."""
    return op.bands.dtype == torch.float32


def _carries(V, vp, vpp):
    """vp' and vpp' after S steps: views of V, or the input vp when S == 1."""
    S = V.shape[0]
    if S == 0:
        return vp, vpp
    return V[S - 1], (V[S - 2] if S >= 2 else vp)


def lanczos_resident_steps_reference(op: KroneckerSumOperator, vp, vpp, beta, S: int, out: Optional[torch.Tensor] = None) -> ResidentSteps:
    """Plain version, in f32, with the kernel's arithmetic order."""
    d, _, n = op.bands.shape
    V = torch.empty((S, d, n), dtype=torch.float32, device=vp.device) if out is None else out
    alpha = torch.empty((d, S), dtype=torch.float32, device=vp.device)
    betas = torch.empty((d, S), dtype=torch.float32, device=vp.device)
    v_1, v_2, b = vp, vpp, beta
    for j in range(S):
        w = spmv_reference(op, v_1) - b[:, None] * v_2
        a = fixed_order_sum(w * v_1)
        u = w - a[:, None] * v_1
        b_new = _sqrt_rn(fixed_order_sum(u * u))
        ok = b_new > FREEZE
        inv = torch.where(ok, 1.0 / torch.where(ok, b_new, 1.0), 0.0)
        V[j] = u * inv[:, None]
        b = torch.where(ok, b_new, 0.0)
        alpha[:, j], betas[:, j] = a, b
        v_1, v_2 = V[j], v_1
    return ResidentSteps(V, alpha, betas, *_carries(V, vp, vpp), b)


def _u_bytes(n: int, G: int) -> int:
    """The dynamic shared memory of a launch: a block's ceil(ceil(n / BLOCK) / G)
    chunks of u where they fit in U_SHARED_BYTES, else 0 (u in the scratch row)."""
    chunks = -(-n // BLOCK)
    nbytes = -(-chunks // G) * BLOCK * 4
    return nbytes if nbytes <= U_SHARED_BYTES else 0


def _max_active_clusters(G: int, device: int, smem: int) -> int:
    """How many clusters of G kernel blocks, each with smem bytes of dynamic
    shared memory, the card holds at once (cudaOccupancyMaxActiveClusters);
    0 when it cannot launch one."""
    return max_active_clusters("tk_resident_lanczos_max_clusters", device, G, smem)


def resident_lanczos_plan(d: int, n: int, device=None) -> int:
    """G, the blocks per factor of the kernel's cluster: ``cluster_plan`` with
    the kernel's occupancy at its u placement (G=8 at d=10, n=131072 and at
    d=8, n=2^20 on the H100)."""
    index = device_index(device)
    return cluster_plan(d, -(-n // BLOCK), _sm_count(index),
                        lambda G: _max_active_clusters(G, index, _u_bytes(n, G)))


def _resident_cuda(op: KroneckerSumOperator, vp, vpp, beta, S: int, out: Optional[torch.Tensor]) -> ResidentSteps:
    bands = op.bands
    d, nb, n = bands.shape
    if bands.dtype != torch.float32:
        raise TypeError(f"resident Lanczos kernel takes f32 bands, got {bands.dtype}")
    if not bands.is_contiguous():
        raise ValueError("resident Lanczos kernel takes contiguous bands")
    for name, t, shape in (("vp", vp, (d, n)), ("vpp", vpp, (d, n)), ("beta", beta, (d,))) + (
            (("out", out, (S, d, n)),) if out is not None else ()):
        if t.device != bands.device or t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {bands.device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got {tuple(t.shape)}")
    G = resident_lanczos_plan(d, n, bands.device)
    if S < 0 or d * G > 2**31 - 1:
        raise ValueError(f"resident Lanczos kernel takes S >= 0 and fewer than 2**31 blocks, got S={S}, d={d}, G={G}")
    lib = _build.kernels()
    if lib.tk_resident_lanczos_block_elems() != BLOCK:
        raise RuntimeError("csrc/resident_lanczos.cu and fused_lanczos.BLOCK disagree on the chunk size")
    dev = bands.device
    V = torch.empty((S, d, n), dtype=torch.float32, device=dev) if out is None else out
    alpha = torch.empty((d, S), dtype=torch.float32, device=dev)
    betas = torch.empty((d, S), dtype=torch.float32, device=dev)
    beta_last = beta.clone()
    # u (d, n), then the chunk sums of the two reductions (d, 2, ceil(n / BLOCK))
    scratch = torch.empty(d * (n + 2 * -(-n // BLOCK)), dtype=torch.float32, device=dev)
    u_shared = _u_bytes(n, G) > 0
    with torch.cuda.device(dev):
        err = lib.tk_resident_lanczos_f32(
            bands.data_ptr(), op.offsets_tensor.data_ptr(), vp.data_ptr(), vpp.data_ptr(), beta.data_ptr(),
            V.data_ptr(), alpha.data_ptr(), betas.data_ptr(), beta_last.data_ptr(), scratch.data_ptr(),
            d, nb, n, S, G, u_shared, _build.stream_of(V))
    _build.check(err, "resident_lanczos")
    if S > 0 and d > 0:
        _build.launches["resident_lanczos"] += 1
    return ResidentSteps(V, alpha, betas, *_carries(V, vp, vpp), beta_last)


def lanczos_resident_steps(op: KroneckerSumOperator, vp, vpp, beta, S: int, out: Optional[torch.Tensor] = None) -> ResidentSteps:
    """Run S complete plain-Lanczos steps for all d factors (f32).

    Args:
      op: operator with f32 bands (d, nb, n).
      vp, vpp: (d, n) f32, the last two basis columns (vpp = 0 at the start).
      beta: (d,) f32, the last subdiagonal (0 at the start).
      S: steps in this call (one kernel launch on CUDA, any S).
      out: optional contiguous (S, d, n) f32 tensor that receives the new
        columns in place, such as the slab ``V[k:k+S]`` of a K-leading basis;
        it must not overlap vp or vpp.

    Returns ResidentSteps (V, alpha, beta, vp', vpp', beta'); vp' and vpp'
    are views of V (or the input vp when S == 1).
    """
    if vp.device.type == "cuda":
        return _resident_cuda(op, vp, vpp, beta, S, out)
    if vp.device.type == "cpu":
        return lanczos_resident_steps_reference(op, vp, vpp, beta, S, out)
    raise ValueError(f"lanczos_resident_steps runs on cuda or cpu tensors, got {vp.device}")
