"""Right-hand sides: counterpart of ``tensorkrylov_tpu/system.py:random_rhs``."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["random_rhs"]


def random_rhs(d: int, n: int, seed: int = 0, identical: bool = True, dtype=torch.float64, device="cpu"):
    """Random rank-1 RHS factors (d, n), uniform [0, 1), drawn with numpy's
    generator exactly as the JAX package draws them, so both packages get the
    identical b. identical=True replicates one draw across the d factors."""
    rng = np.random.default_rng(seed)
    if identical:
        b = np.broadcast_to(rng.random(n), (d, n)).copy()
    else:
        b = rng.random((d, n))
    return torch.as_tensor(b, dtype=dtype, device=device)
