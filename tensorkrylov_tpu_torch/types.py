"""Core data structures of the PyTorch port.

Counterparts of ``tensorkrylov_tpu/types.py``: the Kronecker-sum operator
stores its factors as stacked DIA bands ``(d, nb, n)`` and the CP tensor
stacks its factor matrices into one ``(d, n, t)`` tensor. They are frozen
dataclasses of torch tensors; the device is the device of the tensors.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class KroneckerSumOperator:
    """A = Σ_s I⊗…⊗A_s⊗…⊗I, stored as per-factor DIA bands.

    bands[s, b, i] = A_s[i, i + offsets[b]] for 0 <= i + offsets[b] < n and
    zero outside that range.

    Attributes:
      bands: (d, nb, n) tensor.
      offsets: tuple of nb ints (diagonal offsets).
      symmetric: SPD factors (Lanczos path) vs general (Arnoldi path).
    """

    bands: torch.Tensor
    offsets: Tuple[int, ...]
    symmetric: bool = True

    def __post_init__(self):
        if self.bands.dim() != 3 or self.bands.shape[1] != len(self.offsets):
            raise ValueError(
                f"bands must be (d, nb={len(self.offsets)}, n), got {tuple(self.bands.shape)}"
            )

    @property
    def d(self) -> int:
        return self.bands.shape[0]

    @property
    def n(self) -> int:
        return self.bands.shape[2]

    @property
    def nnz_per_factor(self) -> int:
        """Nonzeros of one factor (band lengths, exact for DIA storage)."""
        return sum(self.n - abs(o) for o in self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.bands.dtype

    @property
    def device(self) -> torch.device:
        return self.bands.device

    @functools.cached_property
    def offsets_tensor(self) -> torch.Tensor:
        """The offsets as an int64 tensor on the bands' device (what the
        kernels read); made once per operator."""
        return torch.tensor(self.offsets, dtype=torch.int64, device=self.device)

    def astype(self, dtype) -> "KroneckerSumOperator":
        if dtype == self.bands.dtype:
            return self
        return KroneckerSumOperator(self.bands.to(dtype), self.offsets, self.symmetric)


@dataclasses.dataclass(frozen=True)
class CPTensor:
    """Rank-t CP (Kruskal) tensor: Σ_j weights[j] · ⊗_s factors[s, :, j].

    Attributes:
      weights: (t,) tensor.
      factors: (d, n, t) tensor.
    """

    weights: torch.Tensor
    factors: torch.Tensor

    @property
    def d(self) -> int:
        return self.factors.shape[0]

    @property
    def n(self) -> int:
        return self.factors.shape[1]

    @property
    def rank(self) -> int:
        return self.factors.shape[2]


class Status(enum.IntEnum):
    """Solver status, as in the JAX package."""

    RUNNING = 0
    CONVERGED = 1
    BREAKDOWN = 2      # compressed-norm breakdown (negative squared norm)
    MAXITER = 3
    LUCKY_BREAKDOWN = 4  # Lanczos/Arnoldi beta == 0


_CHOICES = {
    "orth": ("lanczos", "lanczos_reorth", "lanczos_reorth_auto", "arnoldi"),
    "spectral_source": ("H", "A_minor", "analytic_laplace"),
    "coeff_tol_scale": ("kappa", "reference"),
    "bh_row_select": ("ceil", "reference"),
    "eigh_impl": ("auto", "dense", "tridiag_mixed", "host"),
    "step_impl": ("auto", "xla", "fused", "resident"),
    "nonsym_solve_impl": ("auto", "expm", "eig"),
}


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver configuration: the same fields, defaults and accepted values as
    ``tensorkrylov_tpu.types.SolverConfig``, so one config means the same in
    both packages. The dtypes are torch dtypes.

    step_impl keeps the JAX package's value names:
      'xla'   — the unfused step; its SpMV is the banded-SpMV kernel on CUDA;
      'fused' — the two-pass fused Lanczos kernel (ops/fused_lanczos.py),
                for orth='lanczos'/'lanczos_reorth_auto' in f32 and f64;
      'auto'  — 'xla' until a measurement on the card says otherwise;
      'resident' — in solve_host_projected, the resident multi-step Lanczos
                kernel (ops/resident_lanczos.py) for orth='lanczos', a
                symmetric operator and an f32 basis; 'xla' otherwise, and
                always in solve().
    eigh_impl 'auto' resolves to 'tridiag_mixed' (the tridiagonal eigensolver,
    ops/eigen.py:masked_eigh_tridiag_mixed, the CUDA kernel csrc/tridiag_eigh.cu)
    for a symmetric Lanczos solve on a CUDA device whose projected stage runs
    there, and to 'dense' (torch.linalg.eigh) everywhere else.
    nonsym_solve_impl 'auto' resolves to 'eig' on every device.
    Both entry points record the resolved values on SolveResult.config.
    """

    kmax: int = 128
    tol: float = 1e-9
    orth: str = "lanczos_reorth"
    spectral_source: str = "H"
    tmax: int = 63
    basis_dtype: Any = torch.float64
    proj_dtype: Any = torch.float64
    identical_factors: bool = False
    check_every: int = 1
    step_impl: str = "auto"
    reorth_tol: float = 0.0
    eigh_impl: str = "auto"
    nonsym_solve_impl: str = "auto"
    debug: bool = False
    coeff_tol_scale: str = "kappa"
    bh_row_select: str = "ceil"
    breakdown_rel: float = 256.0
    cancel_floor_rel: float = 64.0

    def __post_init__(self):
        for field, allowed in _CHOICES.items():
            value = getattr(self, field)
            if value not in allowed:
                raise ValueError(f"SolverConfig.{field}={value!r}; expected one of {allowed}")


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Solution and telemetry. The telemetry tensors have kmax+1 entries and
    are valid for indices 1..niterations."""

    x: CPTensor                          # lifted solution (d, n, t), weights (t,)
    status: int                          # Status
    niterations: int
    relative_residual: torch.Tensor      # (kmax+1,)
    projected_residual: torch.Tensor     # (kmax+1,) — r_comp
    orthogonality: torch.Tensor          # (kmax+1,) — loss estimate
    lambda_min: torch.Tensor             # (kmax+1,)
    lambda_max: torch.Tensor             # (kmax+1,)
    expsum_rank: torch.Tensor            # (kmax+1,) int32
    config: Optional[SolverConfig] = None

    @property
    def converged(self) -> bool:
        return self.status == Status.CONVERGED
