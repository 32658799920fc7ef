"""Carry the JAX package's parameters into the port and results back out, as
numpy arrays and plain values, so that one set of inputs can drive both
packages. Nothing here imports JAX types."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coeffs.tables import BHTables
from .types import KroneckerSumOperator, SolveResult, SolverConfig

__all__ = ["operator_from_numpy", "tables_from_numpy", "config_from_fields", "result_to_numpy"]

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
