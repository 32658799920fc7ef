"""Basic SPD solve on the PyTorch port (tensorkrylov_tpu_torch): the
d-dimensional Laplace Kronecker sum, counterpart of examples/01_basic_solve.py.

Run: python examples/01_basic_solve_torch.py          (on the CUDA device)
     python examples/01_basic_solve_torch.py --cpu    (on the CPU)
     add --d D --n N for another size (default d=5, n=200)
"""
import argparse

import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.convergence import summarize


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--d", type=int, default=5)
    p.add_argument("--n", type=int, default=200)
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None                 # None: the CUDA device (raises without one)

    op = tkt.laplace(args.d, args.n, device=device)      # A = Σ_s I⊗…⊗A_s⊗…⊗I, N = n^d
    b = tkt.random_rhs(args.d, args.n, seed=0)
    system = tkt.TensorizedSystem.create(op, b)          # normalizes b per factor

    result = tkt.solve_tensorized_system(system, nmax=args.n, tol=1e-9)
    print(summarize(result, every=25))

    x = result.x  # CPTensor: weights (t,), factors (d, n, t) — never n^d entries
    print(f"solution CP rank: {int(torch.sum(x.weights != 0))}")
    return result


if __name__ == "__main__":
    main()
