"""Command-line interface: counterpart of ``tensorkrylov_tpu/__main__.py``,
with the same subcommands and flags.

    python -m tensorkrylov_tpu_torch solve --gallery laplace --d 5 --n 200 --tol 1e-9
    python -m tensorkrylov_tpu_torch reproduce --dims 5 10 --n 200
    python -m tensorkrylov_tpu_torch info

Without ``--cpu`` every command runs on the CUDA device and fails when there
is none; ``--cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _common(p):
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA device)")
    p.add_argument("--f32", action="store_true", help="f32 basis (projected algebra stays f64)")


def _device(args) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    return torch.device("cuda")


def cmd_solve(args):
    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch.convergence import summarize, to_json

    dev = _device(args)
    if args.gallery == "laplace":
        op = tkt.laplace(args.d, args.n, device=dev)
        orth = args.orth or "lanczos_reorth"
    elif args.gallery == "convdiff":
        op = tkt.conv_diff(args.d, args.n, c=args.convection, device=dev)
        orth = "arnoldi"
    elif args.gallery == "randspd":
        op = tkt.rand_spd(args.d, args.n, seed=args.seed, device=dev)
        orth = args.orth or "lanczos_reorth"
    else:
        raise SystemExit(f"unknown gallery {args.gallery!r}")

    b = tkt.random_rhs(args.d, args.n, seed=args.seed, device=dev)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    cfg = tkt.SolverConfig(
        kmax=args.kmax or args.n,
        tol=args.tol,
        orth=orth,
        check_every=args.check_every,
        tmax=args.tmax,
        basis_dtype=torch.float32 if args.f32 else torch.float64,
    )
    t0 = time.perf_counter()
    res = tkt.solve(op, b, cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    print(summarize(res))
    print(f"wall: {wall:.2f}s on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    if args.json:
        with open(args.json, "w") as f:
            f.write(to_json(res))
        print("traces written to", args.json)
    return 0 if int(res.status) == 1 else 2


def cmd_reproduce(args):
    from tensorkrylov_tpu_torch.experiments.reproduction import run_reproduction

    run_reproduction(args.dims, args.n, args.tol, symmetric=not args.nonsym, out_dir=args.out, device=_device(args))
    return 0


def cmd_info(args):
    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch import native

    dev = _device(args)
    names = ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if dev.type == "cuda"
             else ["cpu"])
    print(
        json.dumps(
            {
                "version": tkt.__version__,
                "torch": torch.__version__,
                "backend": dev.type,
                "devices": names,
                "native_runtime": native.available(),
            },
            indent=2,
        )
    )
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="tensorkrylov_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="solve a gallery Kronecker-sum system")
    ps.add_argument("--gallery", default="laplace", choices=["laplace", "convdiff", "randspd"])
    ps.add_argument("--d", type=int, default=5)
    ps.add_argument("--n", type=int, default=200)
    ps.add_argument("--tol", type=float, default=1e-9)
    ps.add_argument("--kmax", type=int, default=None)
    ps.add_argument("--orth", default=None, choices=[None, "lanczos", "lanczos_reorth", "arnoldi"])
    ps.add_argument("--check-every", type=int, default=1)
    ps.add_argument("--tmax", type=int, default=63)
    ps.add_argument("--convection", type=float, default=10.0)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--json", default=None, help="write traces to this path")
    _common(ps)
    ps.set_defaults(fn=cmd_solve)

    pr = sub.add_parser("reproduce", help="reference reproduction sweep")
    pr.add_argument("--dims", type=int, nargs="+", default=[5, 10, 50, 100])
    pr.add_argument("--n", type=int, default=200)
    pr.add_argument("--tol", type=float, default=1e-9)
    pr.add_argument("--nonsym", action="store_true")
    pr.add_argument("--out", default=None)
    _common(pr)
    pr.set_defaults(fn=cmd_reproduce)

    pi = sub.add_parser("info", help="environment info")
    _common(pi)
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
