"""Targeted reader for the reference's Julia-Serialization experiment blobs:
counterpart of ``tensorkrylov_tpu/utils/julia_serial.py`` (pure numpy; the
port keeps its own copy).

The reference persists finished `Experiment` structs with Julia's built-in
`Serialization`. This module extracts the numerically relevant payload — the
exact RHS vectors and the recorded per-iteration convergence traces —
WITHOUT a full Julia deserializer, by scanning for the typed 1-D array
encoding:

    0x15 0x00 <eltype> <len> <raw little-endian data>

with eltype 0x08 = Int64, 0x0e = Float64, and <len> either a small-int tag
byte (0xdf + value, values 0..32) or 0x31 + int32. Array order in the file
follows the struct field order, which for `Experiment` is:

    dims :: Vector{Int}                      — 1 int array
    rhs_vec[i][s] for i, s                   — Σ dims[i] f64 arrays (len n)
    conv_vector[i] per dim:                  — ConvergenceData
        iterations :: Vector{Int}            (len = niterations)
        relative_residual_norm :: Vector{F}  (len = niterations)
        projected_residual_norm :: Vector{F}
        orthogonality_data :: Vector{F}

(Julia records trace index k = the k×k projected problem; index 1 is the
untouched `ones` placeholder.)
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["scan_typed_arrays", "load_reference_experiment", "ReferenceExperiment"]

_ELT_I64 = 0x08
_ELT_F64 = 0x0E


def scan_typed_arrays(path: str, max_len: int = 1_000_000) -> List[Tuple[str, int, np.ndarray]]:
    """Scan a Julia-Serialization blob for 1-D Int64/Float64 arrays.

    Returns [(kind 'i8'|'f8', byte offset, array)] in file order. Candidate
    matches whose payload would contain non-finite doubles are rejected
    (guards against false positives inside raw data).
    """
    with open(path, "rb") as f:
        buf = f.read()
    out: List[Tuple[str, int, np.ndarray]] = []
    i, N = 0, len(buf)
    while i < N - 4:
        if buf[i] == 0x15 and buf[i + 1] == 0x00 and buf[i + 2] in (_ELT_I64, _ELT_F64):
            elt = buf[i + 2]
            j = i + 3
            b = buf[j]
            ln = None
            if 0xDF <= b <= 0xFF:
                ln = b - 0xDF
                j += 1
            elif b == 0x31 and j + 5 <= N:
                ln = struct.unpack("<i", buf[j + 1 : j + 5])[0]
                j += 5
            if ln is not None and 0 < ln <= max_len and j + 8 * ln <= N:
                arr = np.frombuffer(
                    buf[j : j + 8 * ln], dtype="<i8" if elt == _ELT_I64 else "<f8"
                )
                if elt == _ELT_F64 and not np.all(np.isfinite(arr)):
                    i += 1
                    continue
                out.append(("i8" if elt == _ELT_I64 else "f8", i, arr.copy()))
                i = j + 8 * ln
                continue
        i += 1
    return out


@dataclasses.dataclass
class ReferenceExperiment:
    dims: List[int]
    n: int
    rhs: List[np.ndarray]                 # per dim: (d, n) stacked factor RHS
    traces: List[Dict[str, np.ndarray]]   # per dim: iterations / relative_residual
    #                                       / projected_residual / orthogonality


def load_reference_experiment(path: str) -> ReferenceExperiment:
    """Parse a reproduction-style Experiment blob into arrays."""
    arrays = scan_typed_arrays(path)
    if not arrays or arrays[0][0] != "i8":
        raise ValueError(f"{path}: expected leading dims Int64 array")
    dims = [int(v) for v in arrays[0][2]]
    idx = 1

    # n from the first RHS array length
    if idx >= len(arrays) or arrays[idx][0] != "f8":
        raise ValueError(f"{path}: expected Float64 RHS arrays after dims")
    n = len(arrays[idx][2])

    rhs: List[np.ndarray] = []
    for d in dims:
        vecs = []
        for _ in range(d):
            kind, _, arr = arrays[idx]
            if kind != "f8" or len(arr) != n:
                raise ValueError(f"{path}: RHS structure mismatch at index {idx}")
            vecs.append(arr)
            idx += 1
        rhs.append(np.stack(vecs))

    traces: List[Dict[str, np.ndarray]] = []
    for d in dims:
        kind, _, iters = arrays[idx]
        if kind != "i8":
            raise ValueError(f"{path}: expected iterations Int64 array at index {idx}")
        k = len(iters)
        rel, proj, orth = (arrays[idx + 1 + j][2] for j in range(3))
        if not all(len(a) == k for a in (rel, proj, orth)):
            raise ValueError(f"{path}: ConvergenceData length mismatch for d={d}")
        traces.append(
            {
                "iterations": iters,
                "relative_residual": rel,
                "projected_residual": proj,
                "orthogonality": orth,
            }
        )
        idx += 4

    return ReferenceExperiment(dims=dims, n=n, rhs=rhs, traces=traces)
