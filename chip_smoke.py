#!/usr/bin/env python3
"""Drive the PyTorch port (tensorkrylov_tpu_torch) once on one NVIDIA H100.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one output line each:
  1. device  — a CUDA device whose name contains H100 (and the nvidia-smi line);
  2. build   — nvcc builds the kernels in tensorkrylov_tpu_torch/ops/csrc;
  3. kernels — each CUDA kernel against its plain PyTorch version on the card;
  4. golden  — tests/golden_laplace_d4_n100.json reproduced on the card, and the
               dense-oracle residual at d=3, n=30;
  5. slice   — reaction_diffusion(d=10, n=131072), f64, kmax=200, tol=1e-8, with
               the default step and with the fused step; the kernel launch counts
               must equal the Krylov steps;
  6. card_vs_cpu — the same two solves at d=10, n=4096 on the card and on the CPU.
Then one JSON line of the kernels and, last, {"ok": true, "device": {...}}.
Any failed check exits with code 1 and prints no result line; so do a machine
without CUDA and a directory without the package.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden_laplace_d4_n100.json")
LIMITS = {torch.float64: 1e-12, torch.float32: 1e-5}  # kernel vs plain, relative
TRACE_RTOL = 1e-6       # golden / card-vs-CPU relative-residual traces
SPECTRUM_RTOL = 1e-12   # card-vs-CPU λ_min, λ_max traces


class Failed(Exception):
    pass


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond, what):
    if not cond:
        raise Failed(what)


def sigma_for_kappa(n, kappa):
    """Diagonal shift σ that gives a Laplacian factor the condition number κ."""
    lmax = 4.0 * (n + 1) ** 2 * np.sin(n * np.pi / (2 * (n + 1))) ** 2
    lmin = 4.0 * (n + 1) ** 2 * np.sin(np.pi / (2 * (n + 1))) ** 2
    return float((lmax - kappa * lmin) / (kappa - 1.0))


def unit_rows(rng, shape, dtype, device):
    x = rng.standard_normal(shape)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return torch.tensor(x, dtype=dtype, device=device)


def penta_operator(tkt, d, n, seed, device):
    """Distinct random symmetric, diagonally dominant pentadiagonal factors."""
    rng = np.random.default_rng(seed)
    offsets = (-2, -1, 0, 1, 2)
    bands = np.zeros((d, 5, n))
    for s in range(d):
        for k in (1, 2):
            upper = rng.uniform(-1.0, 1.0, n - k)       # A[i, i+k] = A[i+k, i]
            bands[s, 2 + k, : n - k] = upper
            bands[s, 2 - k, k:] = upper
        bands[s, 2] = 5.0 + rng.uniform(0.0, 1.0, n)
    return tkt.KroneckerSumOperator(torch.tensor(bands, device=device), offsets, True)


def time_pair(fn_plain, fn_kernel, reps=200, warm=20):
    """ms per call of each, timed with CUDA events in the order plain, kernel, kernel, plain."""
    def one(fn):
        for _ in range(warm):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    p1, k1, k2, p2 = one(fn_plain), one(fn_kernel), one(fn_kernel), one(fn_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def phase_device():
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    require("H100" in name, f"device {name!r} is not an H100")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    emit("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi_line


def phase_build():
    from tensorkrylov_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.kernels()
    report = [ln.strip() for ln in _build.build_info["log"].splitlines()
              if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_info["seconds"],
         library=os.path.relpath(_build.build_info["path"], REPO), ptxas=report)


def phase_kernels(tkt):
    from tensorkrylov_tpu_torch.ops.banded import spmv, spmv_reference
    from tensorkrylov_tpu_torch.ops.fused_lanczos import fused_lanczos_core, fused_lanczos_core_reference

    dev = torch.device("cuda")
    scaled_laplace = tkt.laplace(10, 131072, device=dev)
    scaled_laplace = tkt.KroneckerSumOperator(scaled_laplace.bands / (4.0 * 131073**2), scaled_laplace.offsets)
    cases = {"d10_n131072_tridiag": scaled_laplace, "d3_n1001_penta_distinct": penta_operator(tkt, 3, 1001, 5, dev)}
    checks, worst = [], {}
    for case, op64 in cases.items():
        for dtype in (torch.float64, torch.float32):
            op = op64.astype(dtype)
            d, n = op.d, op.n
            rng = np.random.default_rng(11)
            limit = LIMITS[dtype]
            for shape in ((d, n), (d, 4, n)):
                v = unit_rows(rng, shape, dtype, dev)
                got, ref = spmv(op, v), spmv_reference(op, v)
                torch.cuda.synchronize()
                err = rel_err(got, ref)
                checks.append(dict(kernel="banded_spmv", case=case, dtype=str(dtype)[6:], v=list(shape), err=err, limit=limit))
                require(err <= limit, f"banded_spmv {case} {dtype} {shape}: {err} > {limit}")
                if case.startswith("d10") and dtype == torch.float64 and len(shape) == 2:
                    worst["banded_spmv"] = float((got - ref).abs().max())
            v_prev, v_pprev, b = (unit_rows(rng, (d, n), dtype, dev) for _ in range(3))
            beta = torch.tensor(rng.uniform(0.1, 1.0, d), dtype=dtype, device=dev)
            got = fused_lanczos_core(op, v_prev, v_pprev, beta, b)
            ref = fused_lanczos_core_reference(op, v_prev, v_pprev, beta, b)
            torch.cuda.synchronize()
            for name, g, r in zip(("u", "alpha", "beta_sq", "ub"), got, ref):
                err = rel_err(g, r)
                checks.append(dict(kernel="fused_lanczos", case=case, dtype=str(dtype)[6:], out=name, err=err, limit=limit))
                require(err <= limit, f"fused_lanczos {case} {dtype} {name}: {err} > {limit}")
            if case.startswith("d10") and dtype == torch.float64:
                worst["fused_lanczos"] = max(float((g - r).abs().max()) for g, r in zip(got, ref))

    # times at the main path's shape and dtype: d=10, n=131072, tridiagonal, f64
    op = cases["d10_n131072_tridiag"]
    rng = np.random.default_rng(12)
    v, v_pprev, b = (unit_rows(rng, (10, 131072), torch.float64, dev) for _ in range(3))
    beta = torch.full((10,), 0.5, dtype=torch.float64, device=dev)
    times = {
        "banded_spmv": time_pair(lambda: spmv_reference(op, v), lambda: spmv(op, v)),
        "fused_lanczos": time_pair(lambda: fused_lanczos_core_reference(op, v, v_pprev, beta, b),
                                   lambda: fused_lanczos_core(op, v, v_pprev, beta, b)),
    }
    emit("kernels", ok=True, checks=checks,
         ms_at_d10_n131072_f64={k: {"kernel": t[0], "plain": t[1]} for k, t in times.items()})
    return worst, times


def run_solve(tkt, op, b, config):
    from tensorkrylov_tpu_torch.ops import _build

    if op.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    t0 = time.perf_counter()
    res = tkt.solve(op, b, config)
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, dict(_build.launches)


def phase_golden(tkt):
    dev = torch.device("cuda")
    with open(GOLDEN) as f:
        g = json.load(f)
    op = tkt.laplace(g["d"], g["n"], device=dev)
    b = tkt.random_rhs(g["d"], g["n"], seed=g["seed"], device=dev)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    res, wall, _ = run_solve(tkt, op, b, tkt.SolverConfig(kmax=g["n"], tol=g["tol"], orth=g["orth"]))
    require(res.status == g["status"], f"golden status {res.status} != {g['status']}")
    require(res.niterations == g["niterations"], f"golden niterations {res.niterations} != {g['niterations']}")
    rr = res.relative_residual[1:g["niterations"] + 1].cpu().numpy()
    ref = np.asarray(g["relative_residual"])
    trace_err = float(np.max(np.abs(rr - ref) / np.abs(ref)))
    require(trace_err <= TRACE_RTOL, f"golden trace differs by {trace_err} > {TRACE_RTOL}")

    op3 = tkt.laplace(3, 30, device=dev)
    b3 = tkt.random_rhs(3, 30, seed=7, device=dev)
    b3 = b3 / torch.linalg.vector_norm(b3, dim=1, keepdim=True)
    res3, _, _ = run_solve(tkt, op3, b3, tkt.SolverConfig(kmax=30, tol=1e-8))
    true_r = tkt.kron_residual_dense(op3, res3.x, b3)
    require(res3.status == tkt.Status.CONVERGED, f"d=3 n=30 status {res3.status}")
    require(true_r <= 1e-8, f"dense-oracle residual {true_r} > 1e-8")
    emit("golden", status=res.status, niterations=res.niterations, trace_max_rel_err=trace_err,
         trace_rtol=TRACE_RTOL, wall_s=wall, dense_oracle_residual_d3_n30=true_r, dense_limit=1e-8)


CONFIGS = {
    "default": dict(kmax=200, tol=1e-8),
    "fused": dict(kmax=200, tol=1e-8, orth="lanczos_reorth_auto", step_impl="fused"),
}


def slice_problem(tkt, n, device):
    """The slice's operator and unit-norm b, made on the CPU and copied, so
    that every device gets the same bits."""
    op = tkt.reaction_diffusion(10, n, sigma_for_kappa(n, 1e2))
    b = tkt.random_rhs(10, n, seed=1234)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    return tkt.KroneckerSumOperator(op.bands.to(device), op.offsets), b.to(device)


def phase_slice(tkt):
    dev = torch.device("cuda")
    op, b = slice_problem(tkt, 131072, dev)
    runs, launches = {}, {}
    for name, fields in CONFIGS.items():
        res, wall, counts = run_solve(tkt, op, b, tkt.SolverConfig(**fields))
        k = res.niterations
        final = float(res.relative_residual[k])
        x = res.x.factors
        require(res.status == tkt.Status.CONVERGED, f"slice {name}: status {res.status} after {k} steps")
        require(tuple(x.shape) == (10, 131072, 63) and bool(torch.isfinite(x).all()) and final < 1e-8,
                f"slice {name}: bad solution (shape {tuple(x.shape)}, final residual {final})")
        kernel = "fused_lanczos" if name == "fused" else "banded_spmv"
        require(res.config.step_impl == ("fused" if name == "fused" else "xla"), f"slice {name}: step_impl {res.config.step_impl}")
        require(counts.get(kernel, 0) == k, f"slice {name}: {kernel} launched {counts.get(kernel, 0)} times in {k} steps")
        launches[kernel] = counts[kernel]
        runs[name] = dict(status=res.status, niterations=k, final_rel_residual=final, wall_s=wall,
                          iterations_per_s=k / wall, max_memory_allocated=torch.cuda.max_memory_allocated(),
                          launches=counts, step_impl=res.config.step_impl, orth=res.config.orth)
        del res, x  # the next run's peak memory must not count this one's solution
    emit("slice", d=10, n=131072, sigma=sigma_for_kappa(131072, 1e2), runs=runs)
    return launches


def phase_card_vs_cpu(tkt):
    out = {}
    for name, fields in CONFIGS.items():
        res = {}
        for dev in ("cuda", "cpu"):
            op, b = slice_problem(tkt, 4096, torch.device(dev))
            res[dev], _, _ = run_solve(tkt, op, b, tkt.SolverConfig(**fields))
        gpu, cpu = res["cuda"], res["cpu"]
        require(gpu.status == cpu.status and gpu.niterations == cpu.niterations,
                f"{name}: card {gpu.status}/{gpu.niterations} vs cpu {cpu.status}/{cpu.niterations}")
        k = gpu.niterations

        def trace_err(field):
            a = getattr(gpu, field)[1:k + 1].cpu().numpy()
            c = getattr(cpu, field)[1:k + 1].cpu().numpy()
            return float(np.max(np.abs(a - c) / np.abs(c)))

        errs = {f: trace_err(f) for f in ("relative_residual", "lambda_min", "lambda_max")}
        require(errs["relative_residual"] <= TRACE_RTOL,
                f"{name}: residual traces differ by {errs['relative_residual']} > {TRACE_RTOL}")
        require(max(errs["lambda_min"], errs["lambda_max"]) <= SPECTRUM_RTOL, f"{name}: spectra differ by {errs}")
        out[name] = dict(status=gpu.status, niterations=k, **{f"{f}_max_rel_err": e for f, e in errs.items()})
    emit("card_vs_cpu", d=10, n=4096, trace_rtol=TRACE_RTOL, spectrum_rtol=SPECTRUM_RTOL, runs=out)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    try:
        import tensorkrylov_tpu_torch as tkt
    except ImportError as e:
        print(f"chip_smoke: the tensorkrylov_tpu_torch package is not here ({e})", file=sys.stderr)
        return 1
    try:
        name, _ = phase_device()
        phase_build()
        worst, times = phase_kernels(tkt)
        phase_golden(tkt)
        launches = phase_slice(tkt)
        phase_card_vs_cpu(tkt)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    pkg = "tensorkrylov_tpu_torch/ops/csrc"
    kernels = [
        dict(name="banded_spmv", route="cuda", source=f"{pkg}/banded_spmv.cu",
             replaces="tensorkrylov_tpu/ops/pallas/banded_spmv.py:36", launches=launches["banded_spmv"],
             max_abs_err=worst["banded_spmv"], ms=times["banded_spmv"][0], plain_ms=times["banded_spmv"][1]),
        dict(name="fused_lanczos", route="cuda", source=f"{pkg}/fused_lanczos.cu",
             replaces="tensorkrylov_tpu/ops/pallas/fused_lanczos.py:58", launches=launches["fused_lanczos"],
             max_abs_err=worst["fused_lanczos"], ms=times["fused_lanczos"][0], plain_ms=times["fused_lanczos"][1]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
