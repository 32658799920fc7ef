"""User-facing system API: counterpart of ``tensorkrylov_tpu/system.py``."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .solver import solve
from .types import KroneckerSumOperator, SolveResult, SolverConfig

__all__ = ["random_rhs", "multiple_rhs", "TensorizedSystem", "solve_tensorized_system"]


def random_rhs(d: int, n: int, seed: int = 0, identical: bool = True, dtype=torch.float64, device="cpu"):
    """Random rank-1 RHS factors (d, n), uniform [0, 1), drawn with numpy's
    generator exactly as the JAX package draws them, so both packages get the
    identical b. identical=True replicates one draw across the d factors.
    b is made on the CPU unless device says otherwise: the solvers move it to
    the operator's device."""
    rng = np.random.default_rng(seed)
    if identical:
        b = np.broadcast_to(rng.random(n), (d, n)).copy()
    else:
        b = rng.random((d, n))
    return torch.as_tensor(b, dtype=dtype, device=device)


def multiple_rhs(dims, n: int, seed: int = 0, dtype=torch.float64, device="cpu"):
    """One random rank-1 RHS per problem dimension d in dims (the experiment
    sweep helper), on the CPU unless device says otherwise, as random_rhs."""
    return [random_rhs(d, n, seed=seed, dtype=dtype, device=device) for d in dims]


@dataclasses.dataclass(frozen=True)
class TensorizedSystem:
    """A Kronecker-sum system with a rank-1 RHS b (d, n) on the operator's
    device; create() normalizes b per factor by default."""

    op: KroneckerSumOperator
    b: torch.Tensor

    @classmethod
    def create(cls, op: KroneckerSumOperator, b, normalize_rhs: bool = True) -> "TensorizedSystem":
        b = torch.as_tensor(b, device=op.device)
        if tuple(b.shape) != (op.d, op.n):
            raise ValueError(f"b must be (d, n) = ({op.d}, {op.n}), got {tuple(b.shape)}")
        if normalize_rhs:
            b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
        return cls(op, b)

    @property
    def d(self) -> int:
        return self.op.d

    @property
    def n(self) -> int:
        return self.op.n

    def __repr__(self):
        kind = "symmetric" if self.op.symmetric else "nonsymmetric"
        return f"TensorizedSystem(d={self.d}, n={self.n}, {kind}, bands={len(self.op.offsets)})"


def solve_tensorized_system(
    system: TensorizedSystem,
    nmax: int = 128,
    orth: str = "lanczos_reorth",
    tol: float = 1e-9,
    config: Optional[SolverConfig] = None,
) -> SolveResult:
    """solve() of the system with SolverConfig(kmax=nmax, tol=tol, orth=orth),
    or with config when it is given; returns the solution and the telemetry."""
    if config is None:
        config = SolverConfig(kmax=nmax, tol=tol, orth=orth)
    return solve(system.op, system.b, config)
