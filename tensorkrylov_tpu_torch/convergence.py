"""Convergence telemetry formatting and export: counterpart of
``tensorkrylov_tpu/convergence.py``, with the same table layout and JSON keys.
The traces are copied to the host as numpy arrays, from any device."""
from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from .types import SolveResult, Status

__all__ = ["trim", "summarize", "to_json"]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def trim(result: SolveResult) -> Dict[str, np.ndarray]:
    """Per-iteration traces cut to the actual iteration count. Index i
    corresponds to subspace size i+1."""
    ni = int(result.niterations)
    sl = slice(1, ni + 1)
    return {
        "iterations": np.arange(1, ni + 1),
        "relative_residual": _host(result.relative_residual)[sl],
        "projected_residual": _host(result.projected_residual)[sl],
        "orthogonality": _host(result.orthogonality)[sl],
        "lambda_min": _host(result.lambda_min)[sl],
        "lambda_max": _host(result.lambda_max)[sl],
        "expsum_rank": _host(result.expsum_rank)[sl],
    }


def summarize(result: SolveResult, every: int = 10) -> str:
    """Human-readable convergence table: about one row every `every`
    iterations, over the checked ones, and always the last."""
    t = trim(result)
    ni = int(result.niterations)
    status = Status(int(result.status)).name
    lines = [
        f"TensorKrylov solve: {status} after {ni} iterations",
        f"{'k':>5} {'rel.residual':>13} {'proj.residual':>13} {'orth.loss':>10} "
        f"{'λ_min':>10} {'λ_max':>10} {'t':>4}",
    ]
    finite = np.nonzero(np.isfinite(t["relative_residual"]))[0]
    pool = finite if finite.size else np.arange(ni)
    stride = max(len(pool) // max(ni // every, 1), 1)
    idx = list(pool[::stride])
    if pool.size and pool[-1] not in idx:
        idx.append(pool[-1])
    for i in idx:
        lines.append(
            f"{int(t['iterations'][i]):>5} {t['relative_residual'][i]:>13.3e} "
            f"{t['projected_residual'][i]:>13.3e} {t['orthogonality'][i]:>10.2e} "
            f"{t['lambda_min'][i]:>10.3e} {t['lambda_max'][i]:>10.3e} "
            f"{int(t['expsum_rank'][i]):>4}"
        )
    return "\n".join(lines)


def to_json(result: SolveResult) -> str:
    """The trimmed traces, the status name and the iteration count as JSON."""
    t = trim(result)
    payload = {k: v.tolist() for k, v in t.items()}
    payload["status"] = Status(int(result.status)).name
    payload["niterations"] = int(result.niterations)
    return json.dumps(payload)
