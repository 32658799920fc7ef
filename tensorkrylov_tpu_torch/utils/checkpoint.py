"""Exact checkpoint and restore of solver state: counterpart of
``tensorkrylov_tpu/utils/checkpoint.py``.

A carry is a NamedTuple of tensors and plain numbers; it is written with
``torch.save`` as a dict of its fields, so a restore gives the same bits.
The write is atomic: a temporary file in the target's directory, then
``os.replace``.
"""
from __future__ import annotations

import os
import tempfile

import torch

__all__ = ["save_carry", "load_carry"]


def save_carry(path: str, carry) -> None:
    """Write the carry's fields to path, tensors as host copies."""
    payload = {k: (v.detach().cpu() if torch.is_tensor(v) else v) for k, v in carry._asdict().items()}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".pt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_carry(path: str, template):
    """Restore a carry written by save_carry. ``template`` (a freshly
    initialized carry of the same problem and config) gives the fields, the
    type and each tensor's device; a tensor whose shape differs from the
    template's raises."""
    want = template._asdict()
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    if set(loaded) != set(want):
        raise ValueError(f"checkpoint fields {sorted(loaded)} != expected {sorted(want)}")
    out = {}
    for name, ref in want.items():
        a = loaded[name]
        if torch.is_tensor(ref):
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint leaf {name} shape {tuple(a.shape)} != expected {tuple(ref.shape)} — "
                    "checkpoint was written for a different problem size/config"
                )
            a = a.to(ref.device)
        out[name] = a
    return type(template)(**out)
