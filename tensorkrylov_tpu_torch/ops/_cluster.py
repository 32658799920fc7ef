"""The plan of the kernels that run one thread-block cluster of G blocks per
factor: ``csrc/fused_lanczos.cu`` and ``csrc/resident_lanczos.cu``."""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["CLUSTER_SIZES", "cluster_plan", "device_index", "max_active_clusters", "sm_count"]

CLUSTER_SIZES = (1, 2, 4, 8, 16)  # blocks per factor a plan considers; 16 is the H100's largest cluster


def device_index(device=None) -> int:
    """The CUDA device index of device (None: the current device)."""
    index = torch.device("cuda" if device is None else device).index
    return torch.cuda.current_device() if index is None else index


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def max_active_clusters(entry: str, device: int, *args: int) -> int:
    """How many clusters the card holds at once, from the kernel library's
    occupancy entry point ``entry(*args, &clusters)``; 0 when it cannot launch
    one."""
    out = ctypes.c_int64(0)
    with torch.cuda.device(device):
        _build.check(getattr(_build.kernels(), entry)(*args, ctypes.byref(out)), entry)
    return int(out.value)


def cluster_plan(d: int, chunks: int, sms: int, fit) -> int:
    """G, the blocks per factor of a kernel that runs one cluster per factor
    of ``chunks`` 256-element chunks.

    The card runs fit(G) clusters of G at once, so d clusters take
    ceil(d / fit(G)) rounds of chunks / G chunks per block. G minimises that
    product over CLUSTER_SIZES, with at least one cluster fitting and no more
    blocks than chunks; on a tie the smaller G, since the resident kernel at
    G=16 measured 18% slower than at G=8 at d=10, n=131072 on the H100 and 2%
    faster at d=8, n=2^20 (PERF.md). When d fills every SM, G = 1."""
    if d >= sms:
        return 1
    best, best_cost = 1, None
    for G in CLUSTER_SIZES:
        if G > sms or (G > 1 and G > chunks):
            break
        clusters = fit(G)
        if clusters < 1:
            continue
        cost = -(-d // clusters) / G
        if best_cost is None or cost < best_cost:
            best, best_cost = G, cost
    return best
