"""tensorkrylov_tpu_torch — the PyTorch and CUDA port of tensorkrylov_tpu.

Solves A x = b for SPD Kronecker sums A = Σ_s I⊗…⊗A_s⊗…⊗I with a rank-1
right-hand side, in low-rank form. The JAX package ``tensorkrylov_tpu`` is the
reference; this package mirrors its module and function names, imports torch
and numpy and never jax. On a CUDA device the Krylov step runs the CUDA
kernels in ``ops/csrc`` (built with nvcc at first use).
"""
from .types import CPTensor, KroneckerSumOperator, SolveResult, SolverConfig, Status
from .solver import solve
from .system import random_rhs
from .models.gallery import (
    bands_to_dense,
    dense_to_bands,
    laplace,
    operator_from_dense_factors,
    rand_spd,
    reaction_diffusion,
)
from .utils.cp import cp_dot, cp_full, cp_norm, kron_matvec_dense, kron_residual_dense

__all__ = [
    "CPTensor",
    "KroneckerSumOperator",
    "SolveResult",
    "SolverConfig",
    "Status",
    "solve",
    "random_rhs",
    "laplace",
    "reaction_diffusion",
    "rand_spd",
    "dense_to_bands",
    "bands_to_dense",
    "operator_from_dense_factors",
    "cp_dot",
    "cp_full",
    "cp_norm",
    "kron_matvec_dense",
    "kron_residual_dense",
]
