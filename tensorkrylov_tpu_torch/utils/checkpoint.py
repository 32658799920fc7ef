"""Exact checkpoint and restore of solver state: counterpart of
``tensorkrylov_tpu/utils/checkpoint.py``.

A carry is a NamedTuple of tensors, lists of tensors (a sharded solve's
basis pieces) and plain numbers; it is written with ``torch.save`` as a dict
of its fields, so a restore gives the same bits.
The write is atomic: a temporary file in the target's directory, then
``os.replace``.
"""
from __future__ import annotations

import os
import tempfile

import torch

__all__ = ["save_carry", "load_carry"]


def _host(v):
    if isinstance(v, list):
        return [_host(x) for x in v]
    return v.detach().cpu() if torch.is_tensor(v) else v


def _restore(name: str, a, ref):
    """a with ref's shape checked and on ref's device (each piece of a list)."""
    if isinstance(ref, list):
        if not isinstance(a, list) or len(a) != len(ref):
            raise ValueError(f"checkpoint leaf {name} is not {len(ref)} pieces")
        return [_restore(f"{name}[{i}]", x, r) for i, (x, r) in enumerate(zip(a, ref))]
    if torch.is_tensor(ref):
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(
                f"checkpoint leaf {name} shape {tuple(a.shape)} != expected {tuple(ref.shape)} — "
                "checkpoint was written for a different problem size/config"
            )
        return a.to(ref.device)
    return a


def save_carry(path: str, carry) -> None:
    """Write the carry's fields to path, tensors as host copies."""
    payload = {k: _host(v) for k, v in carry._asdict().items()}
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
    return type(template)(**{name: _restore(name, loaded[name], ref) for name, ref in want.items()})
