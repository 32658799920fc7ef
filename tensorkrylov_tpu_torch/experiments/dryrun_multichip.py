"""The JAX package's multi-chip dry run on the port: counterpart of
``__graft_entry__.py:dryrun_multichip``.

One small sharded solve through every call of that dry run, at its own sizes
(d = 4, n = 16 · mode shards), over a ('factor', 'mode') mesh of the given
shard slots (2 factor groups when their number is even), and each call held
to what the JAX dry run asserts:

  * ``solve_sharded`` on the gspmd and the ring route: the same status, steps
    within ±1;
  * ``solve_deflated(mesh=)`` on storage='twopass' over the ring route, and on
    storage='df64', final='device' over gspmd: steps taken, pass 2's audit, a
    certified bound and a cross-check;
  * ``solve_block_recorded`` (unsharded: no mesh in either package) with a
    certified bound;
  * ``solve_block(shard_operator(op, mesh), shard_rhs(B, mesh, d), cfg)`` and
    ``solve_two_pass(shard_operator(op, mesh), shard_rhs(b, mesh), cfg)``;
  * where the slots are a multiple of 4, ``solve_multi_rhs`` on a
    ('rhs', 'factor', 'mode') mesh of 2 × 2 × P, R = 2: ``status`` of shape (2,).

A failed check raises AssertionError. The slots may repeat a device.

On the card:  python -m tensorkrylov_tpu_torch.experiments.dryrun_multichip        (8 slots of cuda:0)
On the CPU:   python -m tensorkrylov_tpu_torch.experiments.dryrun_multichip --cpu
"""
from __future__ import annotations

import argparse
import json
from typing import Sequence

import numpy as np


def _check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def run(devices: Sequence) -> dict:
    """Every call of the JAX dry run over a mesh of the slots `devices`;
    returns each call's status and steps."""
    import torch

    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch.parallel import make_mesh, shard_operator, shard_rhs, solve_sharded

    n_devices = len(devices)
    factor_parallel = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(devices=devices, factor_parallel=factor_parallel)
    dev = mesh.lead
    d = 4  # divisible by the factor axis
    n = 16 * (n_devices // factor_parallel)  # divisible by the mode axis
    op = tkt.laplace(d, n, device=dev)
    b = tkt.random_rhs(d, n, seed=1)
    b = (b / torch.linalg.vector_norm(b, dim=1, keepdim=True)).to(dev)
    out = dict(mesh=mesh.shape, d=d, n=n)

    def row(res, **extra):
        return dict(status=int(res.status), niterations=int(res.niterations), **extra)

    res = solve_sharded(op, b, tkt.SolverConfig(kmax=8, tol=1e-3), mesh)
    _check(res.niterations >= 1, f"solve_sharded took {res.niterations} steps")
    res_r = solve_sharded(op, b, tkt.SolverConfig(kmax=8, tol=1e-3), mesh, comm="ring")
    # the two routes agree to roundoff: the same outcome, steps within one
    _check(res_r.status == res.status and abs(res_r.niterations - res.niterations) <= 1,
           f"ring {res_r.status}/{res_r.niterations} vs gspmd {res.status}/{res.niterations}")
    out.update(solve_sharded_gspmd=row(res), solve_sharded_ring=row(res_r))

    rd = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=6, tol=1e-3), m=4, storage="twopass", mesh=mesh,
                            comm="ring")
    _check(rd.niterations >= 1 and rd.pass2_beta_rel_dev is not None, f"deflated twopass: {rd.niterations} steps")
    rdf = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=6, tol=1e-3), m=4, storage="df64", final="device",
                             mesh=mesh)
    _check(rdf.niterations >= 1 and rdf.certified_bound and rdf.measured_cp_residual is not None,
           f"deflated df64: {rdf.niterations} steps, bounds {rdf.certified_bound}")
    out.update(deflated_twopass_ring=row(rd, certified_bound=rd.certified_bound[-1]),
               deflated_df64_gspmd=row(rdf, certified_bound=rdf.certified_bound[-1]))

    B2 = torch.stack([b, 0.5 * b + 0.1])                      # (R=2, d, n)
    rbr = tkt.solve_block_recorded(op, B2, tkt.SolverConfig(kmax=4, tol=1e-3), final="host")
    _check(rbr.niterations >= 1 and rbr.certified_bound, f"block recorded: {rbr.niterations} steps")
    res_b = tkt.solve_block(shard_operator(op, mesh), shard_rhs(B2, mesh, d), tkt.SolverConfig(kmax=4, tol=1e-3))
    _check(res_b.niterations >= 1, f"sharded solve_block took {res_b.niterations} steps")
    res_t = tkt.solve_two_pass(shard_operator(op, mesh), shard_rhs(b, mesh),
                               tkt.SolverConfig(kmax=6, tol=1e-3, orth="lanczos"))
    _check(res_t.niterations >= 1, f"sharded solve_two_pass took {res_t.niterations} steps")
    out.update(block_recorded=row(rbr, certified_bound=rbr.certified_bound[-1]), block_sharded=row(res_b),
               two_pass_sharded=row(res_t))

    if n_devices % 4 == 0:
        mesh3 = make_mesh(devices=devices, factor_parallel=2, rhs_parallel=2)
        n3 = 16 * (n_devices // 4)
        op3 = tkt.laplace(2, n3, device=dev)
        B = torch.tensor(np.random.default_rng(0).uniform(size=(2, 2, n3)), device=dev)
        _, res3 = tkt.solve_multi_rhs(op3, B, tkt.SolverConfig(kmax=6, tol=1e-3), mesh=mesh3)
        _check(tuple(res3.status.shape) == (2,), f"multi-RHS status shape {tuple(res3.status.shape)}")
        out["multi_rhs_3d"] = dict(mesh=mesh3.shape, n=n3, status=res3.status.tolist(),
                                   niterations=res3.niterations.tolist())
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--slots", type=int, default=8, help="shard slots of the one device")
    p.add_argument("--cpu", action="store_true", help="slots of the CPU (default: of cuda:0)")
    args = p.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip: no CUDA device; pass --cpu to run the slots on the CPU")
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    out = run([dev] * args.slots)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
