#!/usr/bin/env python3
"""Time the fused Lanczos core, the multi-apply SpMV and the tridiagonal
eigensolver of two checkouts of the port on one CUDA card, each in its own
process, in the order A, B, B, A.

    python3 scripts/kernel_ab.py --roots OTHER_CHECKOUT . [--kernels tridiag_eigh]

Each process imports tensorkrylov_tpu_torch from its root (which builds that
root's kernels), holds each kernel against its plain version bit for bit and
prints one JSON line of times (CUDA events after warm-up):

- ``fused``: d=10, n=131072, f64, tridiagonal; ``ms`` the call, ``device_ms``
  the call captured in a CUDA graph and replayed (its launches without the
  host's Python), and the launches of one call;
- ``resident_spmv``: m=200 applies at d=8, n=2^20 in f32 and f64 of laplace
  (3 bands), a distinct pentadiagonal and a distinct 7-band operator; ms per
  call and the launches of one call;
- ``tridiag_eigh``: f64, on the slice's own Lanczos T (d=10, K=201) at its
  last check k=29 and its first factor alone (d=1, identical factors), and
  on the flagship operator's T at K=513, k=384 (``chip_smoke.lanczos_H`` of
  the root); ms per call and the launches of one call; then the host's
  view: µs per ``masked_eigh_tridiag_mixed`` call (with Newton–Schulz) over
  the slice's checks k = 1..29 (``slice_checks_us``), and the wall s of 7
  warm default ``solve`` runs of the slice (``slice_solve_warm_s``).

The last line is one JSON object with each root's runs side by side.
"""
import argparse
import json
import os
import subprocess
import sys
import time

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


KERNELS = ("fused", "resident_spmv", "tridiag_eigh")


def measure(root, kernels):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(tkt.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise SystemExit(f"imported {pkg}, not the package of {root}")
    dev = torch.device("cuda")
    out = {"root": root}
    if "fused" in kernels:
        out["fused"] = measure_fused(tkt, torch, np, _build, dev)
    if "resident_spmv" in kernels:
        out["resident_spmv"] = measure_resident_spmv(tkt, torch, np, _build, dev)
    if "tridiag_eigh" in kernels:
        out["tridiag_eigh"] = measure_tridiag(tkt, torch, np, _build, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


def measure_fused(tkt, torch, np, _build, dev):
    from tensorkrylov_tpu_torch.ops.fused_lanczos import fused_lanczos_core, fused_lanczos_core_reference

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
    return dict(ms=time_ms(torch, call, 200, 20), device_ms=time_ms(torch, graph.replay, 200, 20),
                launches_per_call=launches)


def measure_resident_spmv(tkt, torch, np, _build, dev):
    from tensorkrylov_tpu_torch.ops.resident_spmv import spmv_multi_apply, spmv_multi_apply_reference

    d, n = SPMV_SHAPE
    ops = {"laplace": (tkt.laplace(d, n, device=dev), 1.0 / (4.0 * (n + 1) ** 2)),
           "penta": (banded(tkt, torch, np, d, n, 2, 17, dev), 0.125),
           "seven": (banded(tkt, torch, np, d, n, 3, 6, dev), 0.1)}
    out = {}
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
            out[f"{name}_{str(dtype)[6:]}"] = dict(
                ms=time_ms(torch, lambda: spmv_multi_apply(op, x, APPLIES, c), 3, 1), launches_per_call=launches)
    return out


def measure_tridiag(tkt, torch, np, _build, dev):
    import chip_smoke as cs
    from tensorkrylov_tpu_torch.ops.eigen import masked_eigh_tridiag_mixed, masked_eigh_tridiag_reference, tridiag_eigh

    op_s, b_s = cs.slice_problem(tkt, 131072, dev)
    H_slice = cs.lanczos_H(op_s, b_s, cs.TRIDIAG_SLICE_K - 1)
    q = cs.TRIDIAG_FLAGSHIP
    op = tkt.reaction_diffusion(10, 131072, cs.sigma_for_kappa(131072, q["kappa"]), device=dev)
    b = cs.unit_rows(np.random.default_rng(1234), (10, 131072), torch.float64, dev)
    H_flag = cs.lanczos_H(op, b, q["K"] - 1)
    del op, b
    out = {}
    cases = (("slice_K201_k29", H_slice, 29, 200), ("slice_d1_K201_k29", H_slice[:1].contiguous(), 29, 200),
             ("flagship_K513_k384", H_flag, q["k"], 50))
    for case, H, k, reps in cases:
        torch.cuda.synchronize()
        _build.launches.clear()
        got = tridiag_eigh(H, k)
        torch.cuda.synchronize()
        launches = _build.launches["tridiag_eigh"]
        if not all(torch.equal(g, r) for g, r in zip(got, masked_eigh_tridiag_reference(H, k))):
            raise SystemExit(f"tridiag_eigh {case} differs from its plain version")
        out[case] = dict(ms=time_ms(torch, lambda: tridiag_eigh(H, k), reps, 5), launches_per_call=launches)
    checks = range(1, 30)
    for k in checks:
        masked_eigh_tridiag_mixed(H_slice, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        for k in checks:
            masked_eigh_tridiag_mixed(H_slice, k)
    torch.cuda.synchronize()
    out["slice_checks_us"] = (time.perf_counter() - t0) / (20 * len(checks)) * 1e6
    cfg = tkt.SolverConfig(**cs.CONFIGS["default"])
    tkt.solve(op_s, b_s, cfg)
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tkt.solve(op_s, b_s, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["slice_solve_warm_s"] = walls
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"), help="two checkouts, run in the order A, B, B, A")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS, default=list(KERNELS), help="the kernels to time")
    ap.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        return measure(args.measure, args.kernels)
    if not args.roots:
        ap.error("--roots A B is required")
    runs = {root: [] for root in args.roots}
    a, b = args.roots
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root,
                               "--kernels", *args.kernels], capture_output=True, text=True, timeout=900)
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
