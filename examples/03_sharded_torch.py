"""Mode-sharded solves on the PyTorch port over a ('factor', 'mode') mesh,
counterpart of examples/03_sharded.py.

The mesh is 4 shard slots of one device (cuda:0, or the CPU with --cpu),
2 factor groups × 2 mode shards; the same code takes a list of cards. First
solve_sharded, the plain solve with its Krylov bases split over the mesh;
then the deflated solve with the same split (solve_deflated(mesh=)), the
basis-free two-pass storage on the ring route.

Run: python examples/03_sharded_torch.py          (4 shard slots of cuda:0)
     python examples/03_sharded_torch.py --cpu    (4 shard slots of the CPU)
     add --d D --n N for another size (default d=4, n=256)
"""
import argparse

import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.parallel import make_mesh, solve_sharded


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--d", type=int, default=4)
    p.add_argument("--n", type=int, default=256)
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run the shard slots on the CPU")
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    d, n = args.d, args.n

    mesh = make_mesh(devices=[device] * 4, factor_parallel=2)   # 2-way factor × 2-way mode
    print("mesh:", mesh.shape, "lead:", mesh.lead)

    op = tkt.laplace(d, n, device=device)
    b = tkt.random_rhs(d, n, seed=0)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)

    res = solve_sharded(op, b, tkt.SolverConfig(kmax=128, tol=1e-8), mesh)
    ni = int(res.niterations)
    print(f"solve_sharded: status={int(res.status)} niter={ni} rel_res={float(res.relative_residual[ni]):.2e}")

    # the shift sets the conditioning; 8 eigenpairs per factor are deflated
    op_s = tkt.laplace(d, n, shift=2e4, device=device)
    rd = tkt.solve_deflated(op_s, b, tkt.SolverConfig(kmax=64, tol=1e-8), m=8, storage="twopass",
                            mesh=mesh, comm="ring")
    print(f"solve_deflated(mesh=, twopass, ring): status={rd.status} k={rd.niterations} "
          f"certified bound {rd.certified_bound[-1]:.2e} cross-check {rd.measured_cp_residual:.2e}")
    return res, rd


if __name__ == "__main__":
    main()
