"""Multi-process execution: counterpart of ``tensorkrylov_tpu/parallel/multihost.py``.

Process init, the pod mesh and data placement on ``torch.distributed``. One
process runs per rank (``torchrun``, or the ``TK_*`` variables); each owns
``local_device_count`` shard slots, its card repeated or the CPU, and holds
only the shards of those slots (``parallel/sharding.py``). A rank's halos
cross to its neighbours by send and receive (``parallel/halo.py``), its
n-sized partial sums are all-gathered and added in shard order on every rank
(``parallel/krylov.psum``), so every rank runs the same k-sized projected
stage on the same bits and returns the same result.

Axis → process policy, as in the JAX package:

  * 'factor' — the d Krylov recurrences are independent: only the k-sized
    α and β sums cross this axis. It spans the processes (the slow links).
  * 'mode'   — shards each factor's length-n axis: the SpMV's halo and every
    dot's partials cross it. It stays on one process's slots where it can;
    factor_parallel < processes spans it across processes, and its halos
    then travel between them.

The backend follows one rule (``choose_backend``): NCCL when every rank has
a card of its own, gloo on the CPU or when ranks share a card (NCCL refuses
two ranks on one card). Nothing switches backend quietly: where the rule
picks NCCL and NCCL cannot start, init_distributed raises.
"""
from __future__ import annotations

import atexit
import datetime
import os
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..types import KroneckerSumOperator
from .sharding import Mesh, ShardedOperator, _normalize, shard_operator, shard_rhs

__all__ = [
    "init_distributed",
    "make_pod_mesh",
    "global_array",
    "distribute_problem",
    "choose_backend",
]

TIMEOUT = datetime.timedelta(seconds=60)   # a missing peer fails the group instead of hanging it

# this process's slots, set by init_distributed: its device and how many slots it owns
_local = {"device": None, "count": 1}


def choose_backend(cards: Sequence[str]) -> str:
    """The backend for ranks whose devices are cards[r]: 'cpu' for a rank on
    the CPU, else an identity of its card (host and UUID). NCCL when every
    rank has a card of its own; gloo on the CPU or when two ranks share a
    card."""
    if any(c == "cpu" for c in cards) or len(set(cards)) < len(cards):
        return "gloo"
    return "nccl"


def _local_device(process_id: int) -> torch.device:
    """This rank's device: the CPU without a card, else card LOCAL_RANK (or
    the process id) modulo the host's cards."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    slot = int(os.environ.get("LOCAL_RANK", process_id))
    return torch.device("cuda", slot % torch.cuda.device_count())


def _card_identity(dev: torch.device) -> str:
    if dev.type == "cpu":
        return "cpu"
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", dev.index)
    return f"{socket.gethostname()}/{uuid}"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
) -> int:
    """Initialize the process group. Returns the process index.

    The arguments, else TK_COORDINATOR (host:port) / TK_NUM_PROCESSES /
    TK_PROCESS_ID, else the variables torchrun sets (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks the card). With none of
    them this is one process: nothing starts and 0 is returned.
    local_device_count is the number of shard slots this process owns
    (make_pod_mesh's default devices: its card repeated, or the CPU). The
    ranks exchange their cards' identities through a TCP store at the
    coordinator, the backend follows choose_backend, and the group is made
    with a 60 s timeout and checked with a barrier.
    """
    if local_device_count is not None:
        if local_device_count < 1:
            raise ValueError(f"local_device_count must be >= 1, got {local_device_count}")
        _local["count"] = int(local_device_count)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    coordinator_address = coordinator_address or os.environ.get("TK_COORDINATOR")
    if num_processes is None and "TK_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TK_NUM_PROCESSES"])
    if process_id is None and "TK_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TK_PROCESS_ID"])
    agent_store = False
    if coordinator_address is None and num_processes is None:
        torchrun = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
        if not all(k in os.environ for k in torchrun):
            _local["device"] = _local_device(0)
            return 0
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        num_processes, process_id = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        # torchrun's agent already serves the store at MASTER_PORT
        agent_store = os.environ.get("TORCHELASTIC_USE_AGENT_STORE", "").lower() == "true"
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator address, the number of processes and this "
                         f"process's id; got {coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} is not in [0, {num_processes})")
    host, port = coordinator_address.rsplit(":", 1)
    dev = _local_device(process_id)
    _local["device"] = dev
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0 and not agent_store,
                          timeout=TIMEOUT)
    store.set(f"tk_card_{process_id}", _card_identity(dev))
    cards = [store.get(f"tk_card_{r}").decode() for r in range(num_processes)]
    backend = choose_backend(cards)
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError(f"every rank has a card of its own ({cards}), so the backend is NCCL, but this "
                               "torch has no NCCL")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes, timeout=TIMEOUT)
    atexit.register(_shutdown)
    if backend == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
    return process_id


def _shutdown() -> None:
    """The group ends with the process: left to the interpreter's teardown,
    gloo's threads abort it."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _this_device() -> torch.device:
    if _local["device"] is None:
        _local["device"] = _local_device(dist.get_rank() if dist.is_initialized() else 0)
    return _local["device"]


def make_pod_mesh(factor_parallel: Optional[int] = None, devices=None) -> Mesh:
    """('factor', 'mode') mesh with 'factor' spanning the processes and
    'mode' each process's slots (module docstring).

    devices are this process's slots, by default its card repeated
    local_device_count times (init_distributed); without a card pass CPU
    devices. The slots of every process are listed process-major, each
    rank's a contiguous run, and reshaped to (factor_parallel, slots //
    factor_parallel); factor_parallel defaults to the number of processes.
    """
    if devices is None:
        dev = _this_device()
        if dev.type != "cuda":
            raise RuntimeError("no CUDA device: pass devices=[torch.device('cpu')] * L for a mesh on the CPU")
        devices = [dev] * _local["count"]
    local = [_normalize(dev) for dev in devices]
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world > 1:
        names: List[Optional[List[str]]] = [None] * world
        dist.all_gather_object(names, [str(dev) for dev in local])
        if len({len(x) for x in names}) != 1:
            raise ValueError(f"every process must own as many slots, got {[len(x) for x in names]}")
        slots = [(r, torch.device(s)) for r, x in enumerate(names) for s in x]
    else:
        slots = [(0, dev) for dev in local]
    n_dev = len(slots)
    if factor_parallel is None:
        factor_parallel = max(world, 1)
    if factor_parallel < 1 or n_dev % factor_parallel != 0:
        raise ValueError(f"{n_dev} devices not divisible by factor_parallel={factor_parallel}")
    if len({dev.type for _, dev in slots}) > 1:
        raise ValueError(f"a mesh is all cpu or all cuda, got {sorted({str(dev) for _, dev in slots})}")
    P = n_dev // factor_parallel
    grid = tuple(tuple(dev for _, dev in slots[g * P:(g + 1) * P]) for g in range(factor_parallel))
    if world == 1:
        return Mesh(grid)
    ranks = tuple(tuple(r for r, _ in slots[g * P:(g + 1) * P]) for g in range(factor_parallel))
    return Mesh(grid, ranks=ranks, rank=dist.get_rank())


def _index(spec: Sequence[Optional[str]], shape: Tuple[int, ...], mesh: Mesh, g: int, p: int):
    """Slot (g, p)'s index into an array of shape split by spec."""
    parts = {"factor": (g, mesh.shape["factor"]), "mode": (p, mesh.shape["mode"])}
    idx = []
    for axis, size in zip(spec, shape):
        if axis is None:
            idx.append(slice(None))
            continue
        i, count = parts[axis]
        if size % count:
            raise ValueError(f"an axis of {size} does not split over the {count} slots of '{axis}'")
        idx.append(slice(i * size // count, (i + 1) * size // count))
    return tuple(idx)


def global_array(x, mesh: Mesh, spec: Sequence[Optional[str]]) -> List[torch.Tensor]:
    """Host-replicated numpy → this process's pieces: one per slot it owns,
    in slot order, on the slot's device, each x's part that spec assigns it
    (spec names per axis 'factor', 'mode' or None, the JAX PartitionSpec's
    entries; an axis not named is whole on every slot)."""
    x = np.asarray(x)
    if len(spec) > x.ndim:
        raise ValueError(f"spec {tuple(spec)} has more axes than x {x.shape}")
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    return [torch.from_numpy(np.ascontiguousarray(x[_index(spec, x.shape, mesh, g, p)])).to(dev)
            for g, row in enumerate(mesh.devices) for p, dev in enumerate(row) if mesh.owns(g, p)]


def distribute_problem(op: KroneckerSumOperator, b, mesh: Mesh,
                       comm: str = "gspmd") -> Tuple[ShardedOperator, List[torch.Tensor]]:
    """Shard (operator, rhs) over the pod mesh: bands and b's n-axis over
    'mode', d over 'factor' when it divides d (global_array's split with spec
    ('factor' or None, 'mode')). Problem assembly is O(d·n): every process
    builds the same copy and keeps its own shards. Returns the
    ShardedOperator of this rank's shards for comm's SpMV and this rank's
    pieces of b, which every solver takes."""
    return shard_operator(op, mesh, comm), shard_rhs(torch.as_tensor(b, device=op.device), mesh, op.d)
