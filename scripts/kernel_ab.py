#!/usr/bin/env python3
"""Time the fused Lanczos core and the multi-apply SpMV of two checkouts of
the port on one CUDA card, each in its own process, in the order A, B, B, A.

    python3 scripts/kernel_ab.py --roots OTHER_CHECKOUT .

Each process imports tensorkrylov_tpu_torch from its root (which builds that
root's kernels), holds each kernel against its plain version bit for bit and
prints one JSON line of times (CUDA events after warm-up):

- ``fused``: d=10, n=131072, f64, tridiagonal; ``ms`` the call, ``device_ms``
  the call captured in a CUDA graph and replayed (its launches without the
  host's Python), and the launches of one call;
- ``resident_spmv``: m=200 applies at d=8, n=2^20 in f32 and f64 of laplace
  (3 bands), a distinct pentadiagonal and a distinct 7-band operator; ms per
  call and the launches of one call.

The last line is one JSON object with each root's runs side by side.
"""
import argparse
import json
import os
import subprocess
import sys

FUSED_SHAPE = (10, 131072)
SPMV_SHAPE = (8, 1 << 20)
APPLIES = 200


def time_ms(torch, fn, reps, warm):
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def banded(tkt, torch, np, d, n, h, seed, dev):
    """Distinct random symmetric, diagonally dominant factors with offsets -h..h."""
    rng = np.random.default_rng(seed)
    bands = np.zeros((d, 2 * h + 1, n))
    for s in range(d):
        for k in range(1, h + 1):
            upper = rng.uniform(-1.0, 1.0, n - k)
            bands[s, h + k, : n - k] = upper
            bands[s, h - k, k:] = upper
        bands[s, h] = 2 * h + 1 + rng.uniform(0.0, 1.0, n)
    return tkt.KroneckerSumOperator(torch.tensor(bands, device=dev), tuple(range(-h, h + 1)), True)


def measure(root):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.ops.fused_lanczos import fused_lanczos_core, fused_lanczos_core_reference
    from tensorkrylov_tpu_torch.ops.resident_spmv import spmv_multi_apply, spmv_multi_apply_reference

    pkg = os.path.dirname(os.path.abspath(tkt.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise SystemExit(f"imported {pkg}, not the package of {root}")
    dev = torch.device("cuda")
    out = {"root": root}

    d, n = FUSED_SHAPE
    lap = tkt.laplace(d, n, device=dev)
    op = tkt.KroneckerSumOperator(lap.bands / (4.0 * (n + 1) ** 2), lap.offsets)
    rng = np.random.default_rng(12)
    v, v_pprev, b = (torch.tensor(rng.standard_normal((d, n)), device=dev) for _ in range(3))
    beta = torch.full((d,), 0.5, dtype=torch.float64, device=dev)
    call = lambda: fused_lanczos_core(op, v, v_pprev, beta, b)
    ref = fused_lanczos_core_reference(op, v, v_pprev, beta, b)
    torch.cuda.synchronize()
    _build.launches.clear()
    got = call()
    torch.cuda.synchronize()
    launches = _build.launches["fused_lanczos"]
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise SystemExit("fused_lanczos differs from its plain version")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(g, r) for g, r in zip(captured, ref)):
        raise SystemExit("the replayed fused_lanczos graph differs from its plain version")
    out["fused"] = dict(ms=time_ms(torch, call, 200, 20), device_ms=time_ms(torch, graph.replay, 200, 20),
                        launches_per_call=launches)

    d, n = SPMV_SHAPE
    ops = {"laplace": (tkt.laplace(d, n, device=dev), 1.0 / (4.0 * (n + 1) ** 2)),
           "penta": (banded(tkt, torch, np, d, n, 2, 17, dev), 0.125),
           "seven": (banded(tkt, torch, np, d, n, 3, 6, dev), 0.1)}
    out["resident_spmv"] = {}
    for name, (op64, c) in ops.items():
        for dtype in (torch.float32, torch.float64):
            op = op64.astype(dtype)
            x = torch.tensor(np.random.default_rng(15).standard_normal((d, n)), dtype=dtype, device=dev)
            torch.cuda.synchronize()
            _build.launches.clear()
            got = spmv_multi_apply(op, x, APPLIES, c)
            torch.cuda.synchronize()
            launches = _build.launches["resident_spmv"]
            if not torch.equal(got, spmv_multi_apply_reference(op, x, APPLIES, c)):
                raise SystemExit(f"resident_spmv {name} {dtype} differs from its plain version")
            out["resident_spmv"][f"{name}_{str(dtype)[6:]}"] = dict(
                ms=time_ms(torch, lambda: spmv_multi_apply(op, x, APPLIES, c), 3, 1), launches_per_call=launches)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"), help="two checkouts, run in the order A, B, B, A")
    ap.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        return measure(args.measure)
    if not args.roots:
        ap.error("--roots A B is required")
    runs = {root: [] for root in args.roots}
    a, b = args.roots
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[root].append(json.loads(line))
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
