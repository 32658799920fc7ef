"""Carry the JAX package's parameters into the port and results back out, as
numpy arrays and plain values, so that one set of inputs can drive both
packages. Nothing here imports JAX types."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coeffs.tables import BHTables
from .ops.orth import KrylovState
from .types import KroneckerSumOperator, SolveResult, SolverConfig

__all__ = ["operator_from_numpy", "tables_from_numpy", "config_from_fields", "result_to_numpy",
           "krylov_state_from_numpy", "krylov_state_to_numpy", "sharded_operator_from_numpy",
           "sharded_state_from_numpy", "sharded_state_to_numpy"]

_DTYPE_FIELDS = ("basis_dtype", "proj_dtype")


def operator_from_numpy(bands, offsets, symmetric: bool = True, device="cpu") -> KroneckerSumOperator:
    """Operator from (d, nb, n) bands and their offsets; keeps the bands' dtype."""
    bands = np.ascontiguousarray(np.asarray(bands))
    return KroneckerSumOperator(torch.tensor(bands, device=device), tuple(int(o) for o in offsets), bool(symmetric))


def tables_from_numpy(arrays: dict, dtype=torch.float64, device="cpu") -> BHTables:
    """BH tables from a dict of arrays with the BHTables field names."""
    floats = {f: torch.tensor(np.asarray(arrays[f]), dtype=dtype, device=device)
              for f in ("R_values", "err", "omega", "alpha")}
    return BHTables(grid=torch.tensor(np.asarray(arrays["grid"]), dtype=torch.int64, device=device), **floats)


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.dtype):
        return x
    return getattr(torch, np.dtype(x).name if not isinstance(x, str) else x)


def config_from_fields(fields: dict) -> SolverConfig:
    """SolverConfig from a dict of field values; the dtype fields may be
    names ('float64') or anything numpy can read as a dtype."""
    fields = dict(fields)
    for f in _DTYPE_FIELDS:
        if f in fields:
            fields[f] = _torch_dtype(fields[f])
    return SolverConfig(**fields)


def result_to_numpy(res: SolveResult) -> dict:
    """SolveResult as a dict of numpy arrays and plain values."""
    out = {f.name: getattr(res, f.name) for f in dataclasses.fields(res) if f.name not in ("x", "config")}
    out = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v) for k, v in out.items()}
    out["weights"] = res.x.weights.detach().cpu().numpy()
    out["factors"] = res.x.factors.detach().cpu().numpy()
    return out


def krylov_state_from_numpy(V, H, btil, beta, device="cpu") -> KrylovState:
    """KrylovState from numpy arrays in the JAX package's layout (V (K, d, n),
    H (d, K, K), b̃ (d, K), β (d,)); keeps each array's dtype. A mid-solve
    state of one package can so drive the other's next steps."""
    return KrylovState(*(torch.tensor(np.ascontiguousarray(np.asarray(a)), device=device) for a in (V, H, btil, beta)))


def krylov_state_to_numpy(state) -> KrylovState:
    """The state's four arrays as numpy arrays, in the same layout."""
    return KrylovState(*(np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a) for a in state))


def sharded_operator_from_numpy(bands, offsets, mesh, symmetric: bool = True, comm: str = "gspmd"):
    """operator_from_numpy split over mesh (parallel/sharding.py:shard_operator)."""
    from .parallel.sharding import shard_operator

    op = operator_from_numpy(bands, offsets, symmetric)
    return shard_operator(op, mesh, comm)


def sharded_state_from_numpy(V, H, btil, beta, sop) -> KrylovState:
    """A KrylovState in the JAX package's layout split as the sharded steps
    keep it: V (K, d, n) into per-shard slabs (K, d_f, n_local), H, b̃ and β
    on the lead device."""
    from .parallel.sharding import _split

    V = torch.tensor(np.ascontiguousarray(np.asarray(V)))
    rest = (torch.tensor(np.ascontiguousarray(np.asarray(a)), device=sop.device) for a in (H, btil, beta))
    return KrylovState(_split(V, sop.mesh, sop.d, factor_axis=1), *rest)


def sharded_state_to_numpy(state, sop) -> KrylovState:
    """The inverse of sharded_state_from_numpy: numpy arrays, V gathered to (K, d, n)."""
    from .parallel.sharding import gather

    V = gather(state.V, sop.mesh, axis=-1, factor_axis=1)
    return krylov_state_to_numpy(KrylovState(V, *state[1:]))
