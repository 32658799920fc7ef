"""Nonsymmetric convection–diffusion solve on the PyTorch port: Arnoldi +
Stenger sinc coefficients (more terms than the Braess–Hackbusch cap →
tmax=201), counterpart of examples/02_nonsymmetric.py.

Run: python examples/02_nonsymmetric_torch.py          (on the CUDA device)
     python examples/02_nonsymmetric_torch.py --cpu    (on the CPU)
     add --d D --n N for another size (default d=3, n=100)
"""
import argparse

import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.convergence import summarize


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--d", type=int, default=3)
    p.add_argument("--n", type=int, default=100)
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else None                 # None: the CUDA device (raises without one)

    op = tkt.conv_diff(args.d, args.n, c=10.0, device=device)
    b = tkt.random_rhs(args.d, args.n, seed=1)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)

    cfg = tkt.SolverConfig(kmax=args.n, tol=1e-8, orth="arnoldi", tmax=201)
    result = tkt.solve(op, b, cfg)
    print(summarize(result, every=20))
    return result


if __name__ == "__main__":
    main()
