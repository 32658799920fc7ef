"""Certified rank-R solve with the noise-recording block solver, on the
PyTorch port (tensorkrylov_tpu_torch).

A rank-3 tensor-product RHS solved in one shared block Krylov space per
factor, with per-factor spectral deflation, a certificate (sup + boundary +
the recorded relation's dev, η and Fréchet terms) and a basis-free
cross-check of the result.

Run: python examples/04_certified_block_torch.py          (on the CUDA device)
     python examples/04_certified_block_torch.py --cpu    (on the CPU)
"""
import sys

import numpy as np

import tensorkrylov_tpu_torch as tkt

device = "cpu" if "--cpu" in sys.argv[1:] else "cuda"
d, n, R = 3, 256, 3
op = tkt.laplace(d, n, shift=2e4, device=device)   # the shift sets the conditioning
rng = np.random.default_rng(0)
B = rng.standard_normal((R, d, n))                  # rank-R RHS: a sum of R products

res = tkt.solve_block_recorded(
    op, B,
    tkt.SolverConfig(kmax=40, tol=1e-8),
    m=16,                                           # deflate 16 eigenpairs per factor
    verbose=True,
)
print(f"converged={res.converged} in {res.niterations} block iterations "
      f"({res.niterations * R} columns per factor)")
print(f"certified bound : {res.certified_bound[-1]:.3e}")
print(f"cross-check     : {res.measured_cp_residual:.3e} (validity floor {res.cp_residual_floor:.3e})")
x = res.x                                           # CPTensor (rank t·R)
