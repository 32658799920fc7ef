"""tensorkrylov_tpu_torch — the PyTorch and CUDA port of tensorkrylov_tpu.

Solves A x = b for Kronecker sums A = Σ_s I⊗…⊗A_s⊗…⊗I, SPD (Lanczos) or
nonsymmetric (Arnoldi), with a rank-1 right-hand side, in low-rank form. The
JAX package ``tensorkrylov_tpu`` is the reference; this package mirrors its
module and function names, imports torch
and numpy and never jax. On a CUDA device the Krylov step runs the CUDA
kernels in ``ops/csrc`` (built with nvcc at first use); ``solve_host_projected``
runs the Krylov segments on the device and the projected stage on the host.

Entry points: ``solve``, ``solve_host_projected``, ``solve_resumable``,
``solve_multi_rhs``, ``solve_block`` (a rank-R right-hand side in one shared
block Krylov space), ``solve_block_recorded`` (its noise-recording,
certifying counterpart), ``solve_two_pass`` (basis-free, O(d·n) basis memory),
``solve_refined`` (restarted CP refinement), ``solve_deflated`` (per-factor
spectral deflation, the κ = 1e6 flagship's solver; ``storage='df64'`` is its
recorded-relation certificate), ``solve_tensorized_system``,
``parallel.solve_sharded`` (the solve split over a mesh of shard slots); the CLI
``python -m tensorkrylov_tpu_torch solve|reproduce|info`` and the bench
``python -m tensorkrylov_tpu_torch.bench``.
"""
from .types import CPTensor, KroneckerSumOperator, SolveResult, SolverConfig, Status
from .solver import MultiRhsResult, solve, solve_host_projected, solve_multi_rhs, solve_resumable
from .block import solve_block
from .block_recorded import BlockRecordedResult, solve_block_recorded
from .twopass import solve_two_pass
from .refine import RefinedResult, cp_residual, solve_refined
from .deflate import DeflatedResult, DeflationBasis, deflation_basis, solve_deflated
from .system import TensorizedSystem, multiple_rhs, random_rhs, solve_tensorized_system
from .models import gallery
from .models.gallery import (
    bands_to_dense,
    conv_diff,
    dense_to_bands,
    eigval_matrix,
    laplace,
    operator_from_dense_factors,
    operator_from_ragged_factors,
    pad_ragged_rhs,
    rand_spd,
    reaction_diffusion,
)
from .utils.cp import cp_axpy, cp_dot, cp_full, cp_norm, cp_round, kron_apply_cp, kron_matvec_dense, kron_residual_dense

__all__ = [
    "CPTensor",
    "KroneckerSumOperator",
    "SolveResult",
    "SolverConfig",
    "Status",
    "solve",
    "solve_host_projected",
    "solve_resumable",
    "solve_multi_rhs",
    "MultiRhsResult",
    "solve_block",
    "solve_block_recorded",
    "BlockRecordedResult",
    "solve_two_pass",
    "solve_refined",
    "RefinedResult",
    "solve_deflated",
    "deflation_basis",
    "DeflationBasis",
    "DeflatedResult",
    "cp_residual",
    "cp_axpy",
    "cp_round",
    "kron_apply_cp",
    "TensorizedSystem",
    "solve_tensorized_system",
    "random_rhs",
    "multiple_rhs",
    "gallery",
    "laplace",
    "reaction_diffusion",
    "conv_diff",
    "eigval_matrix",
    "rand_spd",
    "dense_to_bands",
    "bands_to_dense",
    "operator_from_dense_factors",
    "operator_from_ragged_factors",
    "pad_ragged_rhs",
    "cp_dot",
    "cp_full",
    "cp_norm",
    "kron_matvec_dense",
    "kron_residual_dense",
]

__version__ = "0.1.0"
