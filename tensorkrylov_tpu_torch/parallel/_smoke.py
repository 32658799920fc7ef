"""Multi-process smoke worker: counterpart of ``tensorkrylov_tpu/parallel/_smoke.py``.

One process of an N-process group running a small sharded solve end to end
on the pod mesh ('factor' across processes, 'mode' over each process's
slots). Run one per rank, by hand:

    python -m tensorkrylov_tpu_torch.parallel._smoke \\
        --coordinator localhost:12356 --num-processes 2 --process-id 0 \\
        --local-devices 2 --cpu

or under ``torchrun --nproc_per_node 2 -m tensorkrylov_tpu_torch.parallel._smoke
--local-devices 2 --cpu`` (the process flags then come from torchrun). Without
--cpu each rank's slots are its card. Prints one machine-readable line:
SMOKE status niter rel_residual procs=N devices=M.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--local-devices", type=int, default=None)
    p.add_argument("--d", type=int, default=4)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--kmax", type=int, default=32)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    if args.cpu:
        # before anything asks for a card: the ranks then choose gloo on the CPU
        os.environ["CUDA_VISIBLE_DEVICES"] = ""

    import numpy as np
    import torch

    import tensorkrylov_tpu_torch as tkt
    from .multihost import distribute_problem, init_distributed, make_pod_mesh

    init_distributed(args.coordinator, args.num_processes, args.process_id, args.local_devices)
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())
    slots = args.local_devices or 1
    # 'factor' across processes, 'mode' on each process's slots
    mesh = make_pod_mesh(devices=[dev] * slots if args.cpu else None)
    op = tkt.laplace(args.d, args.n, device=dev)
    b = tkt.random_rhs(args.d, args.n, seed=1)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)

    sop, bs = distribute_problem(op, b, mesh)
    res = tkt.solve(sop, bs, tkt.SolverConfig(kmax=args.kmax, tol=args.tol))
    ni = int(res.niterations)
    rel = float(np.asarray(res.relative_residual.cpu())[ni])
    print(f"SMOKE {int(res.status)} {ni} {rel:.12e} procs={mesh.processes} "
          f"devices={mesh.shape['factor'] * mesh.shape['mode']}", flush=True)


if __name__ == "__main__":
    main()
