#!/usr/bin/env python3
"""Drive the PyTorch port (tensorkrylov_tpu_torch) once on one NVIDIA H100.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one output line each:
  1. device  — a CUDA device whose name contains H100 (and the nvidia-smi line);
  2. build   — nvcc builds the kernels in tensorkrylov_tpu_torch/ops/csrc;
  3. kernels — each CUDA kernel against its plain PyTorch version on the card
               (the SpMV in f64 and f32; the fused core in f64 and f32, bit
               for bit, with w in shared memory and in u's row, timed at
               d=10, n=131072 in both placements as a call and as a CUDA-graph
               replay of the call (its launch alone); the resident multi-step
               Lanczos kernel in f32, 8 steps from β = 0, bit for bit, at the
               cluster size G its plan picks and at every G of 1, 2, 4, 8,
               16, each timed; the SpMV and 32 resident steps on the bench's
               own d=8, n=2^20 f32 inputs, bit for bit, with the same G sweep;
               the SpMV also at (d, 63, n), one kron_apply_cp of a rank-63 solution;
               the multi-apply SpMV in f64 and f32, 200 applies, bit for bit
               at each of its instantiations: centred 3 bands at the bench's
               d=8, n=2^20, centred 5 bands and the generic one on distinct
               pentadiagonal and 7-band factors, and at d=8, n=2^20 a distinct
               pentadiagonal operator through the 5-band instantiation and,
               forced, the generic one, each timed; its plan (M, T) on the
               phase's line, the launches of one m=200 call on the kernels
               line);
  4. golden  — tests/golden_laplace_d4_n100.json reproduced on the card, and the
               dense-oracle residual at d=3, n=30;
  5. slice   — reaction_diffusion(d=10, n=131072), f64, kmax=200, tol=1e-8, with
               the default step and with the fused step; the kernel launch counts
               must equal the Krylov steps;
  6. card_vs_cpu — the same two solves at d=10, n=4096 on the card and on the CPU;
  7. host_projected — solve_host_projected on the slice's problem with plain f32
               Lanczos, through the resident kernel (one launch per segment) and
               through the unfused step; the resident route at n=4096 on the card
               and on the CPU; the nonsymmetric path: conv_diff(3, 30) through
               solve with Arnoldi (dense oracle), and conv_diff(d=10, n=16384)
               through solve_host_projected at the JAX package's at-scale shape;
  8. entry_points — python -m tensorkrylov_tpu_torch.bench (every key, every
               rate > 0, through the multi-apply kernel); the CLI's solve
               (laplace d=5, n=200, tol 1e-9); solve_tensorized_system; the
               reproduction runner (SPD d = 5, 10, 50, 100 and nonsymmetric
               d = 5, n=200); solve_multi_rhs (R=2) and solve_resumable
               (kmax=40, checkpointed and resumed) on the slice's problem,
               each equal to solve() bit for bit;
  9. sharded — the ring kernel, one launch for the 4 mode shards of
               reaction_diffusion(d=10, n=131072) on the card, against its plain
               version (the halo exchange, then ring_spmv_reference per shard; f64
               and f32, (d, n) and (d, m, n), limit 0.0), timed beside the same call
               captured in a CUDA graph and replayed (its launch without the host's
               Python), the gspmd route, the unsharded banded_spmv and a
               torch.sparse CSR matvec; then
               solve_sharded on the slice's problem four ways (4 mode shards with
               comm='ring' and 'gspmd', a 2 x 2 factor-parallel mesh, Arnoldi), each
               held against the unsharded solve on the card, with the launch counts:
               one ring launch per step (all shards share the card), or 4
               banded_spmv launches per step on the gspmd route;
 10. solvers — solve_two_pass, fused and unfused, against solve with the same config
               on the slice's problem (plain Lanczos): steps, final estimate, x, H's α
               and β bit for bit on the fused route, the launches of each pass, peak
               memory below solve's; solve_block on config 4 (d=10, n=10240, κ=1e4,
               rank-4 B, kmax=96) with one banded_spmv launch per block step and the
               device rank-R cross-check, and at n=1024 on the card against the CPU;
               solve_refined on config 4's operator and b = B[0], its history
               decreasing and its residual equal to the device cross-check's;
 11. deflated — solve_deflated on the κ = 1e6 flagship (d=10, n=131072, m=2048, the
               JAX package's recipe on storage='full'), certified below 1e-8 with one
               banded_spmv launch per step and one for the device cross-check, the
               cross-check not contradicting the bound (its own line, deflated_flagship);
               at the JAX package's mid shape (d=10, n=16384, κ=1e5, m=256) 'full' and
               'twopass' with plain Lanczos, equal bit for bit in T and the bounds,
               'segmented', and a twopass stopped at k=64 and resumed from its state
               cache equal to the uninterrupted one; d=3, n=30 on the card and the CPU.
Each path is driven with the launch counts set to 0 just before it and read
just after. Then one JSON line of the kernels (each with its bound: the larger of its bytes
over 3.35 TB/s and its operations over the peak rate of its type, 67 TFLOP/s f32
and 34 TFLOP/s f64 outside the tensor cores, NVIDIA's H100 SXM data sheet) and,
last, {"ok": true, "device": {...}}.
Any failed check exits with code 1 and prints no result line; so do a machine
without CUDA and a directory without the package.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden_laplace_d4_n100.json")
LIMITS = {torch.float64: 1e-12, torch.float32: 1e-5}  # kernel vs plain, relative
TRACE_RTOL = 1e-6       # golden / card-vs-CPU relative-residual traces
SPECTRUM_RTOL = 1e-12   # card-vs-CPU λ_min, λ_max traces
ROUTE_LAMBDA_RTOL = 1e-4  # resident vs unfused route: λ_min, λ_max traces (two f32 roundings)
# resident vs unfused route: relative-residual traces. Plain f32 Lanczos floors near 1e-5 at k=24 on the
# slice's problem; beyond that each route's rounding drives its own drift (0.51 apart at most in the
# first run on the card), so the bound is 1.0: the same order of magnitude at every check
ROUTE_TRACE_RTOL = 1.0
STEPS = 8                 # resident kernel steps per call in phase 3
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # the resident kernel's blocks per factor, swept in phase 3
BENCH_STEPS = 32          # resident kernel steps per call at the bench's shape: the bench's longest call
RESIDENT_SPMV_APPLIES = 200  # applies per multi-apply call in phase 3: the bench's m1
SHARDS = 4                # mode shards of phase 9, all on cuda:0
KRON_RANK = 63            # columns of one kron_apply_cp of a tmax=63 solution (phase 3's SpMV shape)
SHARDED_TRACE_RTOL, SHARDED_TRACE_ATOL = 1e-8, 1e-12  # sharded vs unsharded solve (tests/test_sharding.py:42-46)
HBM_BYTES_PER_S = 3.35e12                                     # H100 SXM device memory
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 34e12}    # outside the tensor cores


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


def banded_operator(tkt, d, n, h, seed, device):
    """Distinct random symmetric, diagonally dominant factors with the 2h + 1
    centred offsets -h..h (h = 2: pentadiagonal)."""
    rng = np.random.default_rng(seed)
    offsets = tuple(range(-h, h + 1))
    bands = np.zeros((d, 2 * h + 1, n))
    for s in range(d):
        for k in range(1, h + 1):
            upper = rng.uniform(-1.0, 1.0, n - k)       # A[i, i+k] = A[i+k, i]
            bands[s, h + k, : n - k] = upper
            bands[s, h - k, k:] = upper
        bands[s, h] = 2 * h + 1 + rng.uniform(0.0, 1.0, n)
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


def time_one(fn, reps=200, warm=20):
    """ms per call of fn, timed with CUDA events after warm-up."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, dtype):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of dtype, in ms."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOP_S[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def spmv_work(op, v):
    """Bytes (bands and v read once, u written once) and operations (a
    multiply and an add per in-range band entry) of one SpMV of v."""
    e = v.element_size()
    rows = v.numel() // op.n
    return op.bands.numel() * e + 2 * v.numel() * e, 2 * rows * op.nnz_per_factor


def csr_block_diagonal(op):
    """The d factors as one block-diagonal (d·n) × (d·n) CSR matrix: one
    torch.sparse matvec computes the factor SpMV (the library yardstick; the
    port never calls it)."""
    d, nb, n = op.bands.shape
    dev = op.device
    cols = torch.arange(n, device=dev)[:, None] + op.offsets_tensor[None, :]        # (n, nb)
    valid = (cols >= 0) & (cols < n)
    crow = torch.zeros(d * n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(valid.sum(1).repeat(d), 0)
    col = cols[None] + (torch.arange(d, device=dev) * n)[:, None, None]            # (d, n, nb)
    keep = valid[None].expand(d, n, nb)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(crow, col[keep], op.bands.permute(0, 2, 1)[keep], size=(d * n, d * n),
                                       check_invariants=False)


def library_spmv_ms(op, v, ref):
    """ms of one torch.sparse CSR matvec of the block-diagonal operator, after
    checking that it computes ref."""
    A, x = csr_block_diagonal(op), v.reshape(-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        u = (A @ x).reshape(v.shape)
        torch.cuda.synchronize()
        err = rel_err(u, ref)
        require(err <= LIMITS[v.dtype], f"torch.sparse CSR matvec differs from the SpMV by {err}")
        return time_one(lambda: A @ x)


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


@contextlib.contextmanager
def resident_setting(G=None, u_shared_bytes=None):
    """Within the block, the resident kernel launches with G blocks per factor
    whatever its plan says, and/or keeps u in shared memory only where it fits
    in u_shared_bytes (0: never): module settings of ops/resident_lanczos.py,
    restored after."""
    from tensorkrylov_tpu_torch.ops import resident_lanczos as rl

    saved = rl.resident_lanczos_plan, rl.U_SHARED_BYTES
    if G is not None:
        rl.resident_lanczos_plan = lambda d, n, device=None: G
    if u_shared_bytes is not None:
        rl.U_SHARED_BYTES = u_shared_bytes
    try:
        yield
    finally:
        rl.resident_lanczos_plan, rl.U_SHARED_BYTES = saved


@contextlib.contextmanager
def fused_setting(G=None, w_shared_bytes=None):
    """Within the block, the fused kernel launches with G blocks per factor
    whatever its plan says, and/or keeps w in shared memory only where it
    fits in w_shared_bytes (0: never, w in u's row): module settings of
    ops/fused_lanczos.py, restored after."""
    from tensorkrylov_tpu_torch.ops import fused_lanczos as fl

    saved = fl.fused_lanczos_plan, fl.W_SHARED_BYTES
    if G is not None:
        fl.fused_lanczos_plan = lambda d, n, dtype, device=None: G
    if w_shared_bytes is not None:
        fl.W_SHARED_BYTES = w_shared_bytes
    try:
        yield
    finally:
        fl.fused_lanczos_plan, fl.W_SHARED_BYTES = saved


W_PLACEMENTS = {"shared": None, "u_row": 0}  # the fused kernel's w: where its plan puts it, and forced into u's row


@contextlib.contextmanager
def generic_spmv():
    """Within the block, the multi-apply kernel takes its generic instantiation
    for every operator, the centred 3- and 5-band sets too: ops/resident_spmv.py's
    _centred answers no, restored after."""
    from tensorkrylov_tpu_torch.ops import resident_spmv as rs

    saved = rs._centred
    rs._centred = lambda op: False
    try:
        yield
    finally:
        rs._centred = saved


def phase_kernels(tkt):
    from tensorkrylov_tpu_torch.ops.banded import spmv, spmv_reference
    from tensorkrylov_tpu_torch.ops.fused_lanczos import (
        fused_lanczos_core, fused_lanczos_core_reference, fused_lanczos_plan)
    from tensorkrylov_tpu_torch.ops import resident_lanczos
    from tensorkrylov_tpu_torch.ops.resident_lanczos import (
        ResidentSteps, lanczos_resident_steps, lanczos_resident_steps_reference, resident_lanczos_plan)

    dev = torch.device("cuda")
    scaled_laplace = tkt.laplace(10, 131072, device=dev)
    scaled_laplace = tkt.KroneckerSumOperator(scaled_laplace.bands / (4.0 * 131073**2), scaled_laplace.offsets)
    cases = {"d10_n131072_tridiag": scaled_laplace, "d3_n1001_penta_distinct": banded_operator(tkt, 3, 1001, 2, 5, dev)}
    checks, worst = [], {}
    for case, op64 in cases.items():
        for dtype in (torch.float64, torch.float32):
            op = op64.astype(dtype)
            d, n = op.d, op.n
            rng = np.random.default_rng(11)
            limit = LIMITS[dtype]
            # (d, 63, n): one kron_apply_cp of a rank-63 solution (phase 10)
            for shape in ((d, n), (d, 4, n)) + (((d, KRON_RANK, n),) if case.startswith("d10") else ()):
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
            ref = fused_lanczos_core_reference(op, v_prev, v_pprev, beta, b)
            # bit for bit, with w in shared memory (the plan's placement here) and in u's row
            for placement, w_bytes in W_PLACEMENTS.items():
                with fused_setting(w_shared_bytes=w_bytes):
                    got = fused_lanczos_core(op, v_prev, v_pprev, beta, b)
                torch.cuda.synchronize()
                err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
                checks.append(dict(kernel="fused_lanczos", case=case, dtype=str(dtype)[6:], w=placement,
                                   max_abs_err=err, limit=0.0))
                require(err == 0.0, f"fused_lanczos {case} {dtype} w in {placement}: error {err}")
                if case.startswith("d10") and dtype == torch.float64:
                    worst["fused_lanczos"] = max(worst.get("fused_lanczos", 0.0), err)
        # the resident kernel takes f32 only: STEPS steps from a unit start, vpp = 0, β = 0,
        # bit for bit at the plan's cluster size and at every other
        op = op64.astype(torch.float32)
        vp = unit_rows(np.random.default_rng(13), (op.d, op.n), torch.float32, dev)
        start = (vp, torch.zeros_like(vp), torch.zeros(op.d, dtype=torch.float32, device=dev))
        ref = lanczos_resident_steps_reference(op, *start, STEPS)
        plan = resident_lanczos_plan(op.d, op.n, dev)
        for G in (None,) + CLUSTER_SIZES:
            with resident_setting(G):
                got = lanczos_resident_steps(op, *start, STEPS)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            checks.append(dict(kernel="resident_lanczos", case=case, dtype="float32", S=STEPS,
                               G=plan if G is None else G, max_abs_err=err, limit=0.0))
            require(err == 0.0, f"resident_lanczos {case} G={G or plan}: error {err}")
            if case.startswith("d10") and G is None:
                worst["resident_lanczos"] = err

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
    # the fused call in both w placements, and its launch alone: the call captured in a CUDA graph and replayed
    fused = {"G": fused_lanczos_plan(10, 131072, torch.float64, dev)}
    call = lambda: fused_lanczos_core(op, v, v_pprev, beta, b)
    ref64 = call()
    for placement, w_bytes in W_PLACEMENTS.items():
        with fused_setting(w_shared_bytes=w_bytes):
            require(all(torch.equal(g, r) for g, r in zip(call(), ref64)), f"fused_lanczos w in {placement}: bits")
            fused[placement] = dict(ms=time_one(call), device_ms=graph_replay_ms(call, ref64))
    # the launch alone at every G, w where the kernel puts it: the same bits
    fused["device_ms_by_G"] = {}
    for G in CLUSTER_SIZES:
        with fused_setting(G):
            require(all(torch.equal(g, r) for g, r in zip(call(), ref64)), f"fused_lanczos G={G}: bits")
            fused["device_ms_by_G"][G] = graph_replay_ms(call, ref64)
    # the resident kernel at the host-projected path's shape and dtype: f32, one segment of STEPS steps
    op32 = op.astype(torch.float32)
    start = (v.float(), torch.zeros_like(v, dtype=torch.float32), torch.zeros(10, dtype=torch.float32, device=dev))
    times["resident_lanczos"] = time_pair(lambda: lanczos_resident_steps_reference(op32, *start, STEPS),
                                          lambda: lanczos_resident_steps(op32, *start, STEPS), reps=50, warm=5)
    resident_g = dict(plan=resident_lanczos_plan(10, 131072, dev),
                      clusters_that_fit={G: resident_lanczos._max_active_clusters(
                                          G, dev.index or 0, resident_lanczos._u_bytes(131072, G))
                                          for G in CLUSTER_SIZES})
    # at every G, with u in shared memory where it fits (the kernel's choice) and always in the scratch
    # row (L2): the same bits, timed
    ref32 = lanczos_resident_steps(op32, *start, STEPS)
    for key, u_bytes in (("ms", None), ("ms_u_in_l2", 0)):
        resident_g[key] = {}
        for G in CLUSTER_SIZES:
            with resident_setting(G, u_bytes):
                got = lanczos_resident_steps(op32, *start, STEPS)
                require(all(torch.equal(g, r) for g, r in zip(got, ref32)),
                        f"resident_lanczos G={G} {key}: the bits differ")
                resident_g[key][G] = time_one(lambda: lanczos_resident_steps(op32, *start, STEPS), reps=50, warm=5)
    e, d, n, nb = 8, 10, 131072, len(op.offsets)
    sp_bytes, sp_flops = spmv_work(op, v)
    nnz = op.nnz_per_factor
    extra = {
        "banded_spmv": dict(bound(sp_bytes, sp_flops, torch.float64),
                            library_ms=library_spmv_ms(op, v, spmv_reference(op, v))),
        # reads bands, v_prev, v_pprev, b, β; writes u, α, β², ⟨u, b⟩
        "fused_lanczos": dict(bound((nb + 4) * d * n * e + 4 * d * e, d * (2 * nnz + 10 * n), torch.float64),
                              library_ms=None, device_ms=fused["shared"]["device_ms"]),
        # f32, STEPS steps: reads bands, vp, vpp, β; writes V (S, d, n), α, β (d, S), β_last
        "resident_lanczos": dict(bound(((nb + 2 + STEPS) * d * n + (2 * STEPS + 2) * d) * 4,
                                       STEPS * d * (2 * nnz + 9 * n), torch.float32), library_ms=None),
    }
    bench_shape = phase_kernels_bench_shape(checks)
    resident_spmv = phase_kernels_resident_spmv(tkt, checks, worst, times, extra)
    emit("kernels", ok=True, checks=checks,
         ms_at_d10_n131072={k: {"kernel": t[0], "plain": t[1], "dtype": "float32" if k == "resident_lanczos"
                                else "float64"} for k, t in times.items() if k != "resident_spmv"},
         fused_d10_n131072_f64=fused, resident_steps_per_call=STEPS, resident_cluster_d10_n131072=resident_g,
         ms_at_bench_shape=bench_shape, resident_spmv=resident_spmv, bounds=extra)
    return worst, times, extra


def phase_kernels_bench_shape(checks):
    """The SpMV and the resident Lanczos kernel on the bench's own inputs
    (d=8 tridiagonal laplace, n=2^20, f32): one SpMV of the bench's v, and
    BENCH_STEPS resident steps from the bench's unit start, each against its
    plain version bit for bit (the resident kernel at its plan's cluster size
    and at every other); timed there."""
    from tensorkrylov_tpu_torch import bench
    from tensorkrylov_tpu_torch.ops.banded import spmv, spmv_reference
    from tensorkrylov_tpu_torch.ops.resident_lanczos import (
        ResidentSteps, lanczos_resident_steps, lanczos_resident_steps_reference, resident_lanczos_plan)

    dev = torch.device("cuda")
    op, v, _ = bench._spmv_problem(dev, bench.SPMV_D, bench.SPMV_N)
    case = "d8_n1048576_tridiag_bench"
    got, ref = spmv(op, v), spmv_reference(op, v)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    checks.append(dict(kernel="banded_spmv", case=case, dtype="float32", v=list(v.shape), max_abs_err=err,
                       ref_max=float(ref.abs().max()), limit=0.0))
    require(err == 0.0, f"banded_spmv {case}: error {err}")
    vp = bench._unit_start(bench.SPMV_D, bench.SPMV_N, dev)
    start = (vp, torch.zeros_like(vp), torch.zeros(bench.SPMV_D, dtype=torch.float32, device=dev))
    ref = lanczos_resident_steps_reference(op, *start, BENCH_STEPS)
    plan = resident_lanczos_plan(bench.SPMV_D, bench.SPMV_N, dev)
    for G in (None,) + CLUSTER_SIZES:
        with resident_setting(G):
            got = lanczos_resident_steps(op, *start, BENCH_STEPS)
        torch.cuda.synchronize()
        for name, g, r in zip(ResidentSteps._fields, got, ref):
            err = float((g - r).abs().max())
            checks.append(dict(kernel="resident_lanczos", case=case, dtype="float32", S=BENCH_STEPS, out=name,
                               G=plan if G is None else G, max_abs_err=err, limit=0.0))
            require(err == 0.0 and bool(torch.isfinite(g).all()),
                    f"resident_lanczos {case} G={G or plan} {name}: error {err}")
        del got
    del ref
    spmv_ms = time_pair(lambda: spmv_reference(op, v), lambda: spmv(op, v))
    res_ms = time_pair(lambda: lanczos_resident_steps_reference(op, *start, BENCH_STEPS),
                       lambda: lanczos_resident_steps(op, *start, BENCH_STEPS), reps=3, warm=1)
    sweep = {}
    for G in CLUSTER_SIZES:
        with resident_setting(G):
            sweep[G] = time_one(lambda: lanczos_resident_steps(op, *start, BENCH_STEPS), reps=3, warm=1)
    return {"banded_spmv": {"kernel": spmv_ms[0], "plain": spmv_ms[1]},
            f"resident_lanczos_S{BENCH_STEPS}": {"kernel": res_ms[0], "plain": res_ms[1], "G": plan,
                                                "ms_by_G": sweep}}


def phase_kernels_resident_spmv(tkt, checks, worst, times, extra):
    """The multi-apply kernel against its plain version, bit for bit, in f32
    and f64 at each of its instantiations: tridiagonal at the bench's shape
    (d=8, n=2^20, m=200), and distinct pentadiagonal and 7-band factors (d=3,
    n=1001) with m % M != 0; timed at the bench's shape, where a distinct
    pentadiagonal operator also goes through the centred 5-band instantiation
    and, forced, the generic one (both bit for bit). The launches of one
    m=200 call are counted there."""
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.ops.resident_spmv import (
        resident_spmv_plan, spmv_multi_apply, spmv_multi_apply_reference)

    dev = torch.device("cuda")
    bench_op = tkt.laplace(8, 1 << 20, device=dev)
    scale = 1.0 / (4.0 * ((1 << 20) + 1) ** 2)
    m = RESIDENT_SPMV_APPLIES
    cases = {  # name: (operator, scale, the kernel's instantiation)
        "d8_n1048576_tridiag": (bench_op, scale, "centred 3 bands"),
        "d3_n1001_penta_distinct": (banded_operator(tkt, 3, 1001, 2, 5, dev), 0.125, "centred 5 bands"),
        "d3_n1001_7band_distinct": (banded_operator(tkt, 3, 1001, 3, 6, dev), 0.1, "generic"),
    }
    plans = {}
    for case, (op64, c, kind) in cases.items():
        for dtype in (torch.float64, torch.float32):
            op = op64.astype(dtype)
            M, T = resident_spmv_plan(op)
            if case.startswith("d3"):
                require(m % M != 0, f"resident_spmv {case} {dtype}: m={m} is a multiple of M={M}")
            v = unit_rows(np.random.default_rng(14), (op.d, op.n), dtype, dev)
            got, ref = spmv_multi_apply(op, v, m, c), spmv_multi_apply_reference(op, v, m, c)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            plans[f"{case}_{str(dtype)[6:]}"] = dict(M=M, T=T, launches=-(-m // M), m=m, instantiation=kind)
            checks.append(dict(kernel="resident_spmv", case=case, dtype=str(dtype)[6:], instantiation=kind, m=m, M=M,
                               T=T, max_abs_err=err, ref_max=float(ref.abs().max()), limit=0.0))
            require(err == 0.0 and bool(ref.abs().max() > 0), f"resident_spmv {case} {dtype}: error {err}")
            worst["resident_spmv"] = max(worst.get("resident_spmv", 0.0), err)
    ms, launches_per_call = {}, {}
    for dtype in (torch.float32, torch.float64):
        op = bench_op.astype(dtype)
        v = unit_rows(np.random.default_rng(15), (8, 1 << 20), dtype, dev)
        torch.cuda.synchronize()
        _build.launches.clear()
        spmv_multi_apply(op, v, m, scale)
        torch.cuda.synchronize()
        launches_per_call[str(dtype)[6:]] = _build.launches["resident_spmv"]
        ms[str(dtype)[6:]] = time_pair(lambda: spmv_multi_apply_reference(op, v, m, scale),
                                       lambda: spmv_multi_apply(op, v, m, scale), reps=3, warm=1)
    # a distinct pentadiagonal operator at the bench's shape: the centred 5-band instantiation against the
    # generic one, each bit for bit against the plain version and timed
    penta = banded_operator(tkt, 8, 1 << 20, 2, 17, dev)
    penta_ms = {}
    for dtype in (torch.float32, torch.float64):
        op = penta.astype(dtype)
        v = unit_rows(np.random.default_rng(18), (8, 1 << 20), dtype, dev)
        ref = spmv_multi_apply_reference(op, v, m, 0.125)
        row = {}
        for kind, ctx in (("centred_5_bands", contextlib.nullcontext), ("generic", generic_spmv)):
            with ctx():
                M, T = resident_spmv_plan(op)
                got = spmv_multi_apply(op, v, m, 0.125)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                checks.append(dict(kernel="resident_spmv", case="d8_n1048576_penta_distinct", dtype=str(dtype)[6:],
                                   instantiation=kind, m=m, M=M, T=T, max_abs_err=err,
                                   ref_max=float(ref.abs().max()), limit=0.0))
                require(err == 0.0 and bool(ref.abs().max() > 0), f"resident_spmv penta {kind} {dtype}: error {err}")
                row[kind] = dict(ms=time_one(lambda: spmv_multi_apply(op, v, m, 0.125), reps=3, warm=1), M=M, T=T)
        penta_ms[str(dtype)[6:]] = row
        del ref, got
    times["resident_spmv"] = ms["float32"]
    # f32: reads bands and v once, writes u once; m applies of the SpMV and the scaling
    nb, d, n = len(bench_op.offsets), 8, 1 << 20
    flops = m * d * (2 * bench_op.nnz_per_factor + n)
    extra["resident_spmv"] = dict(bound((nb + 2) * d * n * 4, flops, torch.float32), library_ms=None,
                                  launches_per_call=launches_per_call["float32"],
                                  ms_float64=ms["float64"][0], plain_ms_float64=ms["float64"][1])
    # the floor under the kernel's rounding contract: each operation on its own at half the peak rate
    # (the peak counts an FMA as two); computed, not measured
    return dict(plans=plans, launches_per_call_m200=launches_per_call,
                ms_d8_n1048576_m200={k: {"kernel": t[0], "plain": t[1]} for k, t in ms.items()},
                penta_d8_n1048576_m200=penta_ms,
                computed_no_fma_floor_ms=flops / (PEAK_FLOP_S[torch.float32] / 2) * 1e3)


def run_solve(tkt, op, b, config, entry="solve", **kwargs):
    """One solve through the entry point tkt.<entry>, with the launch counts set to
    0 just before it and read just after."""
    from tensorkrylov_tpu_torch.ops import _build

    if op.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    t0 = time.perf_counter()
    res = getattr(tkt, entry)(op, b, config, **kwargs)
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
    op = tkt.reaction_diffusion(10, n, sigma_for_kappa(n, 1e2), device="cpu")
    b = tkt.random_rhs(10, n, seed=1234)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    return tkt.KroneckerSumOperator(op.bands.to(device), op.offsets), b.to(device)


def phase_slice(tkt):
    dev = torch.device("cuda")
    op, b = slice_problem(tkt, 131072, dev)
    runs, launches, traces = {}, {}, {}
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
        traces[name] = res.relative_residual.cpu()
        runs[name] = dict(status=res.status, niterations=k, final_rel_residual=final, wall_s=wall,
                          iterations_per_s=k / wall, max_memory_allocated=torch.cuda.max_memory_allocated(),
                          launches=counts, step_impl=res.config.step_impl, orth=res.config.orth)
        del res, x  # the next run's peak memory must not count this one's solution
    emit("slice", d=10, n=131072, sigma=sigma_for_kappa(131072, 1e2), runs=runs)
    return launches, traces["default"]


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


HOST = dict(kmax=200, tol=1e-8, orth="lanczos", basis_dtype=torch.float32, check_every=8)
NONSYM = dict(d=10, n=16384, kappa=1e4, seed=1234, config=dict(kmax=384, tol=1e-8, orth="arnoldi", tmax=801,
                                                               check_every=16))


def checked(res):
    """The steps at which a check recorded a residual."""
    r = res.relative_residual.cpu().numpy()
    return np.flatnonzero(np.isfinite(r) & (r > 0))


def host_run(tkt, op, b, step_impl):
    """One solve_host_projected run of the HOST config; requires that it took
    the requested route and launched its kernel as often as that route must."""
    res, wall, counts = run_solve(tkt, op, b, tkt.SolverConfig(**HOST, step_impl=step_impl), "solve_host_projected")
    k = res.niterations
    segments = -(-k // HOST["check_every"])
    require(res.config.step_impl == step_impl, f"host_projected {step_impl}: resolved to {res.config.step_impl}")
    if op.device.type == "cuda":
        kernel, want = ("resident_lanczos", segments) if step_impl == "resident" else ("banded_spmv", k)
        require(counts.get(kernel, 0) == want,
                f"host_projected {step_impl}: {kernel} launched {counts.get(kernel, 0)} times, want {want}")
    else:
        require(not counts, f"host_projected {step_impl} on the CPU launched kernels: {counts}")
    idx = checked(res)
    rr = res.relative_residual.numpy()
    summary = dict(status=res.status, niterations=k, segments=segments, final_rel_residual=float(rr[idx[-1]]),
                   best_rel_residual=float(rr[idx].min()), best_at=int(idx[np.argmin(rr[idx])]), wall_s=wall,
                   iterations_per_s=k / wall, launches=counts, step_impl=res.config.step_impl)
    if op.device.type == "cuda":
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return res, summary


def trace_errs(a, c, idx):
    return {f: float(np.max(np.abs(getattr(a, f).numpy()[idx] - getattr(c, f).numpy()[idx])
                            / np.abs(getattr(c, f).numpy()[idx])))
            for f in ("relative_residual", "lambda_min", "lambda_max")}


def phase_host_projected(tkt):
    dev = torch.device("cuda")
    # (a) the slice at full width, resident route against the unfused route
    op, b = slice_problem(tkt, 131072, dev)
    runs, traces = {}, {}
    for impl in ("resident", "xla"):
        res, runs[impl] = host_run(tkt, op, b, impl)
        x = res.x.factors
        require(tuple(x.shape) == (10, 131072, 63) and bool(torch.isfinite(x).all()),
                f"host_projected {impl}: bad solution (shape {tuple(x.shape)})")
        traces[impl] = dataclasses.replace(res, x=None)  # telemetry only: the CPU tensors
        del res, x  # the next run's peak memory must not count this one's solution
    a, c = traces["resident"], traces["xla"]
    require(a.status == c.status, f"host_projected: resident status {a.status} vs xla {c.status}")
    idx = np.intersect1d(checked(a), checked(c))
    route = trace_errs(a, c, idx)
    require(max(route["lambda_min"], route["lambda_max"]) <= ROUTE_LAMBDA_RTOL, f"host_projected routes: {route}")
    require(route["relative_residual"] <= ROUTE_TRACE_RTOL, f"host_projected routes: {route}")
    launches = runs["resident"]["launches"]["resident_lanczos"]

    # (b) card against CPU on the resident route: the same recurrence, bit for bit
    out = {}
    for d_ in ("cuda", "cpu"):
        op4, b4 = slice_problem(tkt, 4096, torch.device(d_))
        out[d_] = host_run(tkt, op4, b4, "resident")
    (gpu, gs), (cpu, _) = out["cuda"], out["cpu"]
    require((gpu.status, gpu.niterations) == (cpu.status, cpu.niterations),
            f"host_projected card {gpu.status}/{gpu.niterations} vs cpu {cpu.status}/{cpu.niterations}")
    cvc = trace_errs(gpu, cpu, checked(cpu))
    require(cvc["relative_residual"] <= TRACE_RTOL, f"host_projected card vs cpu: {cvc}")
    require(max(cvc["lambda_min"], cvc["lambda_max"]) <= SPECTRUM_RTOL, f"host_projected card vs cpu: {cvc}")

    # (c) the nonsymmetric path: the verify recipe through solve, then the at-scale shape
    op3 = tkt.conv_diff(3, 30, device=dev)
    b3 = tkt.random_rhs(3, 30, seed=7, device=dev)
    res3, _, counts3 = run_solve(tkt, op3, b3, tkt.SolverConfig(kmax=30, tol=1e-8, orth="arnoldi", tmax=601))
    dense3 = tkt.kron_residual_dense(op3, res3.x, b3)
    require(res3.status == tkt.Status.CONVERGED and dense3 <= 1e-8,
            f"conv_diff(3, 30) arnoldi: status {res3.status}, dense-oracle residual {dense3}")
    require(counts3.get("banded_spmv", 0) == res3.niterations, f"conv_diff(3, 30): launches {counts3}")
    ns = NONSYM
    sigma = sigma_for_kappa(ns["n"], ns["kappa"])
    opn = tkt.conv_diff(ns["d"], ns["n"], shift=sigma, device=dev)
    bn = tkt.random_rhs(ns["d"], ns["n"], seed=ns["seed"], device=dev)
    bn = bn / torch.linalg.vector_norm(bn, dim=1, keepdim=True)
    resn, walln, countsn = run_solve(tkt, opn, bn, tkt.SolverConfig(**ns["config"]), "solve_host_projected")
    kn = resn.niterations
    idxn = checked(resn)
    xn = resn.x.factors
    require(tuple(xn.shape) == (ns["d"], ns["n"], ns["config"]["tmax"]) and bool(torch.isfinite(xn).all()),
            f"conv_diff at scale: bad solution (shape {tuple(xn.shape)})")
    require(resn.status == tkt.Status.CONVERGED, f"conv_diff at scale: status {resn.status} after {kn} steps")
    require(countsn.get("banded_spmv", 0) == kn, f"conv_diff at scale: launches {countsn}")
    nonsym = dict(d=ns["d"], n=ns["n"], kappa=ns["kappa"], sigma=sigma, config=ns["config"], status=resn.status,
                  niterations=kn, last_rel_residual=float(resn.relative_residual[idxn[-1]]),
                  expsum_rank=int(resn.expsum_rank[idxn[-1]]), wall_s=walln, iterations_per_s=kn / walln,
                  max_memory_allocated=torch.cuda.max_memory_allocated(), launches=countsn)
    emit("host_projected", d=10, n=131072, config={k: str(v) for k, v in HOST.items()}, runs=runs,
         route_trace_max_rel_err=route, route_rtol=dict(lambda_=ROUTE_LAMBDA_RTOL, residual=ROUTE_TRACE_RTOL),
         route_traces={"k": idx.tolist(), **{impl: r.relative_residual.numpy()[idx].tolist()
                                             for impl, r in traces.items()}},
         card_vs_cpu_n4096=dict(status=gpu.status, niterations=gpu.niterations, segments=gs["segments"], **cvc),
         conv_diff_d3_n30=dict(status=res3.status, niterations=res3.niterations, dense_oracle_residual=dense3),
         conv_diff_at_scale=nonsym)
    return launches


BENCH_RATES = ("xla_scan_gnnz_s", "resident_pallas_gnnz_s", "cpu_numpy_gnnz_s", "solver_iters_per_s_f64",
               "solver_loop_xla_gnnz_s", "solver_loop_resident_gnnz_s", "solve_resident_gnnz_s",
               "solve_xla_segment_gnnz_s")
REPRO_DIMS = (5, 10, 50, 100)  # the reference's SPD configuration, n=200, tol=1e-9
RESUME_KMAX = 40               # solve_resumable on the slice: V alone is (kmax+1)·d·n·8 B, 430 MB here


def entry(fn, *args, **kwargs):
    """Call an entry point with the launch counts set to 0 just before it and
    read just after; its standard output is captured and returned."""
    from tensorkrylov_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.launches.clear()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_build.launches), buf.getvalue()


def same_bits(a, b):
    fields = ("relative_residual", "projected_residual", "orthogonality", "lambda_min", "lambda_max", "expsum_rank")
    return ((a.status, a.niterations) == (b.status, b.niterations)
            and all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
            and torch.equal(a.x.weights, b.x.weights) and torch.equal(a.x.factors, b.x.factors))


def phase_entry_points(tkt, slice_trace):
    """The entry points a user calls: the bench, the CLI, the system API, the
    reproduction runner, solve_multi_rhs and solve_resumable. Returns the
    bench run's resident_spmv launches (the kernel's only caller)."""
    from tensorkrylov_tpu_torch import bench
    from tensorkrylov_tpu_torch.__main__ import main as cli
    from tensorkrylov_tpu_torch.experiments.reproduction import run_reproduction
    from tensorkrylov_tpu_torch.solver import _segment, _setup
    from tensorkrylov_tpu_torch.utils.checkpoint import save_carry

    dev = torch.device("cuda")
    out = {}
    # (a) python -m tensorkrylov_tpu_torch.bench
    rc, wall, counts, stdout = entry(bench.main, [])
    line = json.loads(stdout.strip().splitlines()[-1])
    extra = line.get("extra", {})
    missing = ([k for k in ("metric", "value", "unit", "vs_baseline") if k not in line]
               + [k for k in BENCH_RATES + ("platform", "spmv_config", "roofline_3350GBps") if k not in extra])
    require(rc == 0 and not missing, f"bench: rc {rc}, missing keys {missing}")
    bad = {k: extra[k] for k in BENCH_RATES if not (math.isfinite(extra[k]) and extra[k] > 0)}
    require(not bad, f"bench: rates not positive: {bad}")
    require(counts.get("resident_spmv", 0) > 0, f"bench: launches {counts}")
    out["bench"] = dict(wall_s=wall, launches=counts, line=line)
    resident_spmv_launches = counts["resident_spmv"]

    # (b) python -m tensorkrylov_tpu_torch solve --gallery laplace --d 5 --n 200 --tol 1e-9
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traces.json")
        rc, wall, counts, stdout = entry(cli, ["solve", "--gallery", "laplace", "--d", "5", "--n", "200",
                                               "--tol", "1e-9", "--json", path])
        with open(path) as f:
            traces = json.load(f)
    require(rc == 0 and traces["status"] == "CONVERGED" and "CONVERGED" in stdout, f"cli solve: rc {rc}")
    require(counts.get("banded_spmv", 0) == traces["niterations"], f"cli solve: launches {counts}")
    out["cli_solve"] = dict(rc=rc, wall_s=wall, niterations=traces["niterations"],
                            final_rel_residual=traces["relative_residual"][-1], launches=counts)

    # (c) TensorizedSystem and solve_tensorized_system, with the dense oracle
    op3 = tkt.laplace(3, 30, device=dev)
    system = tkt.TensorizedSystem.create(op3, tkt.random_rhs(3, 30, seed=7, device=dev))
    res, wall, counts, _ = entry(tkt.solve_tensorized_system, system, nmax=30, tol=1e-8)
    dense = tkt.kron_residual_dense(op3, res.x, system.b)
    require(res.status == tkt.Status.CONVERGED and dense <= 1e-8 and counts.get("banded_spmv", 0) == res.niterations,
            f"solve_tensorized_system: status {res.status}, dense-oracle residual {dense}, launches {counts}")
    out["tensorized_system"] = dict(system=repr(system), status=res.status, niterations=res.niterations,
                                    dense_oracle_residual=dense, wall_s=wall)

    # (d) the reproduction runner: the reference's SPD configuration, then the nonsymmetric one at d=5
    with tempfile.TemporaryDirectory() as tmp:
        spd, wall, counts, _ = entry(run_reproduction, REPRO_DIMS, 200, device=dev, out_dir=tmp, verbose=False)
        with open(os.path.join(tmp, "reproduction_laplace_n200.json")) as f:
            saved = json.load(f)
    require(sorted(saved) == sorted(str(d) for d in REPRO_DIMS), f"reproduction: saved {sorted(saved)}")
    require(all(spd[d]["status"] == tkt.Status.CONVERGED and spd[d]["final_relative_residual"] < 1e-9
                for d in REPRO_DIMS), f"reproduction: {[(d, spd[d]['status']) for d in REPRO_DIMS]}")
    require(counts.get("banded_spmv", 0) == sum(spd[d]["niterations"] for d in REPRO_DIMS),
            f"reproduction: launches {counts}")
    ns, wall_ns, counts_ns, _ = entry(run_reproduction, (5,), 200, symmetric=False, device=dev, verbose=False)
    require(math.isfinite(ns[5]["final_relative_residual"]) and ns[5]["final_relative_residual"] < 1e-6
            and counts_ns.get("banded_spmv", 0) == ns[5]["niterations"],
            f"reproduction nonsym: {ns[5]['status']}, {ns[5]['final_relative_residual']}, launches {counts_ns}")
    out["reproduction"] = {"spd_wall_s": wall, "nonsym_wall_s": wall_ns, **{
        f"{'spd' if sym else 'nonsym'}_d{d}": {k: r[d][k] for k in ("status", "niterations", "final_relative_residual",
                                                                     "wall_s")}
        for sym, r, dims in ((True, spd, REPRO_DIMS), (False, ns, (5,))) for d in dims}}

    # (e) solve_multi_rhs, R=2, on the slice's problem: lane 0 is phase 5's default solve
    op, b = slice_problem(tkt, 131072, dev)
    b2 = tkt.random_rhs(10, 131072, seed=1235)
    b2 = (b2 / torch.linalg.vector_norm(b2, dim=1, keepdim=True)).to(dev)
    mr, wall, counts, _ = entry(tkt.solve_multi_rhs, op, torch.stack([b, b2]), tkt.SolverConfig(**CONFIGS["default"]))
    x, res = mr
    require(mr.converged and torch.equal(res.relative_residual[0].cpu(), slice_trace),
            f"solve_multi_rhs: statuses {res.status.tolist()}, lane 0 equals solve: "
            f"{torch.equal(res.relative_residual[0].cpu(), slice_trace)}")
    require(tuple(x.factors.shape) == (10, 131072, 126) and bool(torch.isfinite(x.factors).all()),
            f"solve_multi_rhs: bad solution (shape {tuple(x.factors.shape)})")
    require(counts.get("banded_spmv", 0) == int(res.niterations.sum()), f"solve_multi_rhs: launches {counts}")
    out["multi_rhs"] = dict(statuses=res.status.tolist(), niterations=res.niterations.tolist(), wall_s=wall,
                            launches=counts, lane0_equals_solve=True)
    del mr, x, res

    # (f) solve_resumable on the slice's problem with kmax=40: segmented with a checkpoint after
    # each chunk, and resumed from a checkpoint written after 14 steps; both equal solve()
    cfg = tkt.SolverConfig(kmax=RESUME_KMAX, tol=1e-8)
    ref, wall_ref, _, _ = entry(tkt.solve, op, b, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "carry.pt")
        seg, wall_seg, counts_seg, _ = entry(tkt.solve_resumable, op, b, cfg, chunk=16, checkpoint_path=ckpt)
        ckpt_bytes = os.path.getsize(ckpt)
        p, carry = _setup(op, b, cfg, None)
        save_carry(ckpt, _segment(p, carry, 14))
        del p, carry
        resumed, wall_res, counts_res, _ = entry(tkt.solve_resumable, op, b, cfg, checkpoint_path=ckpt, resume=True,
                                                 chunk=9)
    require(ref.status == tkt.Status.CONVERGED, f"solve kmax={RESUME_KMAX}: status {ref.status}")
    require(same_bits(seg, ref) and same_bits(resumed, ref), "solve_resumable differs from solve")
    require(counts_seg.get("banded_spmv", 0) == ref.niterations
            and counts_res.get("banded_spmv", 0) == ref.niterations - 14,
            f"solve_resumable: launches {counts_seg}, {counts_res}")
    out["resumable"] = dict(kmax=RESUME_KMAX, status=ref.status, niterations=ref.niterations, bit_equal=True,
                            checkpoint_bytes=ckpt_bytes, wall_s=dict(solve=wall_ref, segmented=wall_seg,
                                                                      resumed=wall_res))
    emit("entry_points", **out)
    return resident_spmv_launches


SHARDED_SOLVES = {  # name: (factor_parallel, comm, extra SolverConfig fields)
    "ring": (1, "ring", {}),
    "gspmd": (1, "gspmd", {}),
    "ring_factor2x2": (2, "ring", {}),
    "ring_arnoldi": (1, "ring", dict(orth="arnoldi")),
}


def plain_sharded(sop, vs):
    """The ring route's plain version on the card: the halo exchange (copies
    on the current stream), then ring_spmv_reference on every shard."""
    from tensorkrylov_tpu_torch.ops.ring_spmv import ring_spmv_reference
    from tensorkrylov_tpu_torch.parallel.halo import exchange_halos

    halos, _ = exchange_halos(sop, vs)
    return [ring_spmv_reference(sh.op, v, lh, rh) for sh, v, (lh, rh) in zip(sop.shards, vs, halos)]


def graph_replay_ms(fn, ref):
    """ms per replay of fn's work captured in a CUDA graph: its launches
    without the host's Python around them, after checking that a replay
    gives ref's bits."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(out, ref)), "a replayed graph differs from the call")
    return time_one(graph.replay)


def phase_sharded(tkt):
    """The mode-sharded solve on 4 shards of cuda:0: the ring kernel (one
    launch for the 4 shards) against its plain version and timed; then
    solve_sharded four ways against the unsharded solve, each with the launch
    counts set to 0 just before it."""
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.ops.banded import spmv
    from tensorkrylov_tpu_torch.parallel import gather, make_mesh, shard_operator, shard_rhs, solve_sharded
    from tensorkrylov_tpu_torch.parallel.halo import spmv_sharded

    t_phase = time.perf_counter()
    dev, n = torch.device("cuda", 0), 131072
    mesh = make_mesh(devices=[dev] * SHARDS)
    op64, b = slice_problem(tkt, n, dev)
    checks = []
    rng = np.random.default_rng(16)
    for dtype in (torch.float64, torch.float32):
        op = op64.astype(dtype)
        sop = shard_operator(op, mesh, "ring")
        for shape in ((10, n), (10, 4, n)):
            v = unit_rows(rng, shape, dtype, dev)
            vs = shard_rhs(v, mesh)
            _build.launches.clear()
            got = spmv_sharded(sop, vs)
            call_launches = dict(_build.launches)
            ref = plain_sharded(sop, vs)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
            whole = rel_err(gather(got, mesh), spmv(op, v))
            checks.append(dict(kernel="ring_spmv", dtype=str(dtype)[6:], v=list(shape), shards=SHARDS,
                               launches=call_launches, max_abs_err=err, limit=0.0, vs_unsharded_rel=whole,
                               unsharded_limit=LIMITS[dtype]))
            require(call_launches == {"ring_spmv": 1}, f"ring_spmv {dtype} {shape}: launches {call_launches}")
            require(err == 0.0, f"ring_spmv {dtype} {shape}: error {err} against its plain version")
            require(whole <= LIMITS[dtype], f"ring_spmv {dtype} {shape}: {whole} from the unsharded SpMV")

    # times at the main path's shape and dtype: f64, (d, n), 4 shards; the bound counts
    # bands and v read once and u written once (the edges read in place are v's)
    sop = shard_operator(op64, mesh, "ring")
    v = unit_rows(rng, (10, n), torch.float64, dev)
    vs = shard_rhs(v, mesh)
    ring_ms, plain_ms = time_pair(lambda: plain_sharded(sop, vs), lambda: spmv_sharded(sop, vs))
    graph_ms = graph_replay_ms(lambda: spmv_sharded(sop, vs), spmv_sharded(sop, vs))
    gspmd = shard_operator(op64, mesh, "gspmd")
    nbytes, flops = spmv_work(op64, v)
    times = dict(ring_ms=ring_ms, plain_ms=plain_ms, graph_replay_ms=graph_ms, wrapper_ms=ring_ms - graph_ms,
                 gspmd_route_ms=time_one(lambda: spmv_sharded(gspmd, vs)),
                 unsharded_banded_spmv_ms=time_one(lambda: spmv(op64, v)),
                 library_ms=library_spmv_ms(op64, v, spmv(op64, v)), **bound(nbytes, flops, torch.float64))

    # the slice's problem through solve_sharded, each held against the unsharded solve
    refs, unsharded = {}, {}
    for orth in ("lanczos_reorth", "arnoldi"):
        res, wall, counts = run_solve(tkt, op64, b, tkt.SolverConfig(**CONFIGS["default"], orth=orth))
        refs[orth] = dataclasses.replace(res, x=None)
        unsharded[orth] = dict(status=res.status, niterations=res.niterations, wall_s=wall,
                               iterations_per_s=res.niterations / wall,
                               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=counts)
        del res
    runs, launches = {}, {}
    for name, (fp, comm, fields) in SHARDED_SOLVES.items():
        cfg = tkt.SolverConfig(**CONFIGS["default"], **fields)
        m = make_mesh(devices=[dev] * SHARDS, factor_parallel=fp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        t0 = time.perf_counter()
        res = solve_sharded(op64, b, cfg, m, comm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
        ref, k = refs[cfg.orth], res.niterations
        require((res.status, k) == (ref.status, ref.niterations) and res.status == tkt.Status.CONVERGED,
                f"sharded {name}: {res.status}/{k} vs unsharded {ref.status}/{ref.niterations}")
        a, r = res.relative_residual[1:k + 1].cpu().numpy(), ref.relative_residual[1:k + 1].cpu().numpy()
        trace = float(np.max(np.abs(a - r) / np.abs(r)))
        require(bool(np.all(np.abs(a - r) <= SHARDED_TRACE_ATOL + SHARDED_TRACE_RTOL * np.abs(r))),
                f"sharded {name}: traces differ by {trace} (rtol {SHARDED_TRACE_RTOL}, atol {SHARDED_TRACE_ATOL})")
        x = res.x.factors
        require(tuple(x.shape) == (10, n, cfg.tmax) and bool(torch.isfinite(x).all()) and x.device == dev,
                f"sharded {name}: bad solution (shape {tuple(x.shape)}, device {x.device})")
        # all shards share the card: one ring launch per step, or one banded_spmv launch per shard and step
        kernel, other, per_step = (("ring_spmv", "banded_spmv", 1) if comm == "ring"
                                   else ("banded_spmv", "ring_spmv", SHARDS))
        require(counts.get(kernel, 0) == per_step * k and counts.get(other, 0) == 0,
                f"sharded {name}: launches {counts} in {k} steps on {SHARDS} shards of one card")
        require(res.config.step_impl == "xla", f"sharded {name}: step_impl {res.config.step_impl}")
        runs[name] = dict(factor_parallel=fp, comm=comm, orth=cfg.orth, status=res.status, niterations=k,
                          trace_max_rel_err=trace, final_rel_residual=float(a[-1]), wall_s=wall,
                          iterations_per_s=k / wall, max_memory_allocated=torch.cuda.max_memory_allocated(),
                          launches=counts)
        if name == "ring":
            launches["ring_spmv"] = counts["ring_spmv"]
        del res, x
    emit("sharded", d=10, n=n, shards=SHARDS, devices=[str(dev)] * SHARDS, checks=checks,
         ms_f64_d10_n131072=times, trace_rtol=SHARDED_TRACE_RTOL, trace_atol=SHARDED_TRACE_ATOL, runs=runs,
         unsharded=unsharded,
         note="all shards share one card: the path and the kernel, not scaling across cards",
         seconds=time.perf_counter() - t_phase)
    return launches, times, max(c["max_abs_err"] for c in checks if c["dtype"] == "float64" and len(c["v"]) == 2)


# phase 10: the slice's problem through solve_two_pass; config 4 (the rank-4 block problem of
# tensorkrylov_tpu/experiments/config4_block.py) through solve_block; its operator through solve_refined
SOLVERS = dict(
    slice_n=131072, two_pass=dict(kmax=200, tol=1e-8, orth="lanczos"),
    block_d=10, block_n=10240, block_kappa=1e4, block_rank=4, block_seed=1234, block_cpu_n=1024,
    block=dict(kmax=96, tol=1e-8, check_every=8, orth="lanczos_reorth", spectral_source="H"),
    refine=dict(kmax=40, tol=1e-8), refine_kw=dict(max_restarts=2, residual_rank=6, inner_tol=1e-4),
)
TWO_PASS_RTOL, TWO_PASS_X_RTOL = 1e-10, 1e-8  # final estimate (tests/test_twopass.py:25-28), max|x_tp − x| / max|x|
# The unfused two-pass route forms b̃_k = ⟨v_k, b⟩ (the JAX package's formula) where solve forms ub/β: the
# entries differ in their last bits, which moves the Lemma-3.4 estimate by up to about κ·eps·‖b‖ (κ = 1e2
# here), on top of the relative bound
TWO_PASS_ATOL = 1e2 * float(np.finfo(np.float64).eps)
REFINE_ABS = 1e-8  # refine.py's cancellation floor of the CP residual norm, relative to ‖b‖


def peak_bytes(dev):
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def config4_problem(tkt, n, device, p=SOLVERS):
    """Config 4's operator (κ = p['block_kappa'] per factor) and its unit-row
    B (R, d, n) from the seed, made on the CPU and copied, so that every
    device gets the same bits."""
    op = tkt.reaction_diffusion(p["block_d"], n, sigma_for_kappa(n, p["block_kappa"]), device="cpu")
    B = np.random.default_rng(p["block_seed"]).standard_normal((p["block_rank"], p["block_d"], n))
    B /= np.linalg.norm(B, axis=2, keepdims=True)
    return tkt.KroneckerSumOperator(op.bands.to(device), op.offsets), torch.tensor(B, device=device)


def on_host(res):
    """The telemetry of a SolveResult as CPU tensors (x dropped)."""
    fields = ("relative_residual", "projected_residual", "orthogonality", "lambda_min", "lambda_max", "expsum_rank")
    return dataclasses.replace(res, x=None, **{f: getattr(res, f).cpu() for f in fields})


def h_entries_differ(Ha, Hb, k):
    """Which of the recorded α (H[j-1, j-1]) and β (H[j, j-1]) entries of steps
    1..k differ between two projected matrices, and the first step where each does."""
    j = torch.arange(1, k + 1, device=Ha.device)
    out = {}
    for name, (r, c) in (("alpha", (j - 1, j - 1)), ("beta", (j, j - 1))):
        bad = torch.nonzero((Ha[:, r, c] != Hb[:, r, c]).any(dim=0))
        if bad.numel():
            out[name] = int(bad[0]) + 1
    return out


def phase_solvers(tkt, dev=torch.device("cuda"), p=SOLVERS):
    """Phase 10: (b) solve_two_pass, fused and unfused, against solve with the
    same config on the slice's problem; (c) solve_block on config 4 at full
    width with the device rank-R cross-check, and the same solve at n=1024 on
    the card and the CPU; (d) solve_refined on config 4's operator and b = B[0],
    held against the device cross-check. Each path runs with the launch counts
    set to 0 just before it and read just after."""
    from tensorkrylov_tpu_torch import twopass
    from tensorkrylov_tpu_torch.coeffs.tables import load_tables
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.ops.orth import _acc_dtype
    from tensorkrylov_tpu_torch.solver import _segment, _setup
    from tensorkrylov_tpu_torch.utils.cp import cp_residual_cross_check_device

    t_phase = time.perf_counter()
    out = {}
    # (b) two-pass against solve, fused and unfused
    op, b = slice_problem(tkt, p["slice_n"], dev)
    runs = {}
    for name, step_impl in (("fused", "fused"), ("unfused", "auto")):
        cfg = tkt.SolverConfig(**p["two_pass"], step_impl=step_impl)
        ref, wall_ref, counts_ref = run_solve(tkt, op, b, cfg)
        peak_ref = peak_bytes(dev)
        k = ref.niterations
        x_ref = ref.x.factors.cpu()
        ref_final = float(ref.relative_residual[k])
        ref_traces = {f: getattr(ref, f).cpu() for f in ("relative_residual", "projected_residual", "expsum_rank")}
        del ref
        tp, wall, counts = run_solve(tkt, op, b, cfg, "solve_two_pass")
        peak = peak_bytes(dev)
        kt, final = tp.niterations, float(tp.relative_residual[tp.niterations])
        require(tp.status == tkt.Status.CONVERGED and kt == k,
                f"two_pass {name}: status {tp.status} after {kt} steps, solve {k}")
        # fused: the same α, β and b̃ as solve's, so the same bits; unfused: b̃ by another formula
        atol = 0.0 if step_impl == "fused" else TWO_PASS_ATOL * float(torch.prod(torch.linalg.vector_norm(b, dim=1)))
        require(abs(final - ref_final) <= TWO_PASS_RTOL * abs(ref_final) + atol,
                f"two_pass {name}: final estimate {final} vs solve {ref_final} (atol {atol})")
        x = tp.x.factors.cpu()
        x_err = float((x - x_ref).abs().max() / x_ref.abs().max())
        require(bool(torch.isfinite(x).all()) and x_err <= TWO_PASS_X_RTOL, f"two_pass {name}: x differs by {x_err}")
        if step_impl == "fused":
            want = {"fused_lanczos": k, "banded_spmv": k}   # pass 1, pass 2
        else:
            want = {"banded_spmv": 2 * k}
        got = {kern: counts.get(kern, 0) for kern in ("fused_lanczos", "banded_spmv")}
        require(got == {**{"fused_lanczos": 0}, **want}, f"two_pass {name}: launches {counts}, want {want}")
        row = dict(status=tp.status, niterations=kt, step_impl=tp.config.step_impl, final_rel_residual=final,
                   solve_final_rel_residual=ref_final, final_abs_diff=abs(final - ref_final), final_atol=atol,
                   x_max_rel_diff=x_err, wall_s=wall, solve_wall_s=wall_ref, iterations_per_s=kt / wall,
                   max_memory_allocated=peak, solve_max_memory_allocated=peak_ref, launches=counts,
                   solve_launches=counts_ref)
        if dev.type == "cuda":
            require(peak < peak_ref, f"two_pass {name}: peak memory {peak} not below solve's {peak_ref}")
        if step_impl == "fused":
            # the fused route records solve's α and β bit for bit: the same kernel, the same post-processing;
            # H of both from their internals (launches here are not the main path's)
            traces_equal = all(torch.equal(getattr(tp, f).cpu(), t) for f, t in ref_traces.items())
            cfg_r = tp.config
            pr, carry = _setup(op, b, cfg, None)
            H_solve = _segment(pr, carry, cfg_r.kmax).H
            del pr, carry
            acc = _acc_dtype(cfg_r.basis_dtype, cfg_r.proj_dtype)
            H_tp = twopass._pass1(op.astype(acc), twopass._start(b, acc, cfg_r.proj_dtype),
                                  load_tables(device=dev), cfg_r).H
            differ = h_entries_differ(H_solve, H_tp, k)
            require(not differ and traces_equal,
                    f"two_pass fused: H differs from the fused solve's at the first step of {differ} "
                    f"(alpha: the fused core's α or its cast; beta: the β² cast, _sqrt_rn or the breakdown test); "
                    f"traces equal: {traces_equal}")
            row.update(h_alpha_beta_bit_equal=True, traces_bit_equal=True)
            del H_solve, H_tp
        runs[name] = row
        del tp, x, x_ref
    out["two_pass"] = dict(d=op.d, n=op.n, config=p["two_pass"], runs=runs)
    del op, b

    # (c) config 4: the rank-4 block solve at full width, then card against CPU at n=1024
    op4, B = config4_problem(tkt, p["block_n"], dev, p)
    cfg = tkt.SolverConfig(**p["block"])
    res, wall, counts = run_solve(tkt, op4, B, cfg, "solve_block")
    peak = peak_bytes(dev)
    k = res.niterations
    idx = checked(res)
    traces = {f: getattr(res, f).cpu().numpy()[idx] for f in ("relative_residual", "lambda_min", "lambda_max")}
    require(res.status != tkt.Status.BREAKDOWN and all(np.isfinite(t).all() for t in traces.values())
            and bool(torch.isfinite(res.x.factors).all()),
            f"block config 4: status {res.status}, finite: {[bool(np.isfinite(t).all()) for t in traces.values()]}")
    _build.launches.clear()
    check = cp_residual_cross_check_device(op4, res.x.weights, res.x.factors, B)
    check_counts = dict(_build.launches)
    Bh = B.cpu().numpy()
    Gb = np.einsum("rsn,qsn->srq", Bh, Bh).astype(np.longdouble)
    b_norm = float(np.sqrt(max(float(np.prod(Gb, axis=0).sum()), 0.0)))
    require(counts.get("banded_spmv", 0) == k and check_counts.get("banded_spmv", 0) == 1,
            f"block config 4: launches {counts} in {k} block steps, cross-check {check_counts}")
    block = dict(d=op4.d, n=op4.n, kappa=p["block_kappa"], rank=p["block_rank"], config=p["block"],
                 status=res.status, niterations=k, final_rel_residual=float(traces["relative_residual"][-1]),
                 expsum_rank=int(res.expsum_rank[idx[-1]]), wall_s=wall, iterations_per_s=k / wall,
                 max_memory_allocated=peak, launches=counts, cross_check_launches=check_counts,
                 true_rel_residual=check.value / b_norm, true_rel_floor=check.floor / b_norm,
                 below_floor=check.value <= check.floor, b_norm=b_norm)
    del res
    runs_nc = {}
    for d_ in (dev, torch.device("cpu")):
        opc, Bc = config4_problem(tkt, p["block_cpu_n"], d_, p)
        runs_nc[d_.type] = run_solve(tkt, opc, Bc, cfg, "solve_block")[0]
    g, c = runs_nc[dev.type], runs_nc["cpu"]
    require((g.status, g.niterations) == (c.status, c.niterations),
            f"block n={p['block_cpu_n']}: card {g.status}/{g.niterations} vs cpu {c.status}/{c.niterations}")
    cvc = trace_errs(on_host(g), c, checked(c))
    require(cvc["relative_residual"] <= TRACE_RTOL, f"block card vs cpu: {cvc}")
    block["card_vs_cpu"] = dict(n=p["block_cpu_n"], status=g.status, niterations=g.niterations, **cvc)
    out["block_config4"] = block
    del runs_nc, g, c

    # (d) refined on config 4's operator with the rank-1 b = B[0]
    b0 = B[0].contiguous()
    res, wall, counts = run_solve(tkt, op4, b0, tkt.SolverConfig(**p["refine"]), "solve_refined", **p["refine_kw"])
    peak = peak_bytes(dev)
    h = res.residual_history
    kron = counts.get("banded_spmv", 0) - sum(res.inner_iterations)
    require(all(a > c for a, c in zip(h, h[1:])) and len(h) >= 1, f"refined: history not decreasing: {h}")
    require(kron >= len(h), f"refined: {kron} kron_apply_cp launches for {len(h)} residuals ({counts})")
    bn = float(np.prod(np.linalg.norm(b0.cpu().numpy(), axis=1)))
    xc = cp_residual_cross_check_device(op4, res.x.weights, res.x.factors, b0)
    gap = abs(res.true_relative_residual - xc.value / bn)
    require(gap <= (xc.floor + REFINE_ABS * bn) / bn,
            f"refined: true_relative_residual {res.true_relative_residual} vs cross-check {xc.value / bn} "
            f"(floor {xc.floor / bn})")
    out["refined"] = dict(config=p["refine"], **p["refine_kw"], status=res.status, cycles=res.cycles,
                          residual_history=h, inner_iterations=res.inner_iterations, rep_condition=res.rep_condition,
                          true_relative_residual=res.true_relative_residual, x_rank=res.x.rank,
                          cross_check=xc.value / bn, cross_check_floor=xc.floor / bn, wall_s=wall,
                          max_memory_allocated=peak, launches=counts, kron_apply_cp_launches=kron)
    emit("solvers", **out, seconds=time.perf_counter() - t_phase)


# phase 11: the flagship through solve_deflated with the JAX package's recipe
# (tensorkrylov_tpu/experiments/data/northstar_d10_n131072_tpu.json) on storage='full'; the storages at the
# JAX package's mid shape (northstar_mid_d10_n16384_tpu.json); card against CPU on tests/test_deflate.py:137's case
DEFLATED = dict(
    flagship=dict(d=10, n=131072, kappa=1e6, seed=1234, m=2048, checkpoints=[384, 448, 512],
                  config=dict(kmax=512, tol=1e-8, orth="lanczos_reorth_auto")),
    mid=dict(d=10, n=16384, kappa=1e5, seed=1234, m=256, kmax=384, tol=1e-8, segment=32, stop=[32, 64]),
    small=dict(n=30, shift=50.0, seed=7, m=6, checkpoints=[8, 16, 24, 30], config=dict(kmax=30, tol=1e-7)),
)
DEFLATED_BOUND_RTOL = 1e-9   # card vs CPU certified bounds (d=3, n=30, reorthogonalized)
DEFLATED_X_RTOL = 1e-12      # mid shape: twopass's x (pass 2's accumulation) vs full's (V·Yv), relative to max|x|


def deflated_problem(tkt, q, device):
    """reaction_diffusion(d, n, σ(κ)) and b from random_rhs(seed) with unit
    rows, made on the CPU and copied."""
    op = tkt.reaction_diffusion(q["d"], q["n"], sigma_for_kappa(q["n"], q["kappa"]), device="cpu")
    b = tkt.random_rhs(q["d"], q["n"], seed=q["seed"])
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    return tkt.KroneckerSumOperator(op.bands.to(device), op.offsets), b.to(device)


def deflated_summary(res, wall, counts, dev):
    from tensorkrylov_tpu_torch.experiments.northstar import interpret_cross_check

    verdict = interpret_cross_check(res.measured_cp_residual, res.cp_residual_floor, res.certified_bound[-1],
                                    DEFLATED["flagship"]["config"]["tol"])
    return dict(status=res.status, niterations=res.niterations, checkpoints=res.checkpoints,
                estimate=res.relative_residual, certified_bound=res.certified_bound, expsum_sup=res.expsum_sup,
                expsum_rank=res.expsum_rank, measured_cp_residual=res.measured_cp_residual,
                cp_residual_floor=res.cp_residual_floor, cross_check_verdict=verdict,
                orthogonality_drift=res.orthogonality_drift,
                pass2_gram_max=res.pass2_gram_max, pass2_beta_rel_dev=res.pass2_beta_rel_dev,
                projection_leak=res.projection_leak, boundary_drift_max=res.boundary_drift_max, wall_s=wall,
                iterations_per_s=res.niterations / wall, max_memory_allocated=peak_bytes(dev), launches=counts)


def phase_deflated(tkt, dev=torch.device("cuda"), p=DEFLATED):
    """Phase 11: (a) the κ = 1e6 flagship through solve_deflated, storage
    'full', certified below tol with one banded_spmv launch per step and one
    for the device cross-check; (b) at the mid shape, 'full' and 'twopass'
    with plain Lanczos equal bit for bit in T and the bounds, 'segmented', and
    a twopass stopped and resumed from its state cache equal to the
    uninterrupted one; (c) the d=3, n=30 case on the card and the CPU. Each
    solve runs with the launch counts set to 0 just before it and read just
    after. Returns the phase's banded_spmv launches."""
    from tensorkrylov_tpu_torch import deflate_light
    from tensorkrylov_tpu_torch.ops.orth import deflation_project

    t_phase = time.perf_counter()
    out, launched = {}, 0
    xc = int(dev.type == "cuda")   # the device cross-check's A·X (on the CPU the host's numpy check runs)

    # (a) the flagship
    q = p["flagship"]
    op, b = deflated_problem(tkt, q, dev)
    t0 = time.perf_counter()
    basis = tkt.deflation_basis(op, q["m"])
    setup_s = time.perf_counter() - t0
    cfg = tkt.SolverConfig(**q["config"])
    res, wall, counts = run_solve(tkt, op, b, cfg, "solve_deflated", basis=basis, checkpoints=q["checkpoints"],
                                  storage="full")
    k, tol = res.niterations, cfg.tol
    x = res.x.factors
    row = dict(d=q["d"], n=q["n"], kappa=q["kappa"], sigma=sigma_for_kappa(q["n"], q["kappa"]), m=q["m"],
               config=q["config"], storage="full", setup_s=setup_s, **deflated_summary(res, wall, counts, dev),
               lambda_min=res.lambda_min, lambda_max=res.lambda_max, x_shape=list(x.shape))
    verdict = row["cross_check_verdict"]
    out["flagship"] = row
    emit("deflated_flagship", **row)
    require(res.status == tkt.Status.CONVERGED and res.certified_bound[-1] < tol,
            f"deflated flagship: status {res.status} after {k} steps, bounds {res.certified_bound}")
    require("CONTRADICT" not in verdict, f"deflated flagship: the cross-check contradicts the bound: {verdict}")
    require(counts == {"banded_spmv": k + xc}, f"deflated flagship: launches {counts} in {k} steps (want {k + xc})")
    require(x.shape[:2] == (q["d"], q["n"]) and bool(torch.isfinite(x).all()) and x.device.type == dev.type,
            f"deflated flagship: bad solution (shape {tuple(x.shape)}, device {x.device})")
    launched += counts["banded_spmv"]
    del res, x, basis, op, b

    # (b) the storages at the mid shape
    q = p["mid"]
    op, b = deflated_problem(tkt, q, dev)
    basis = tkt.deflation_basis(op, q["m"])
    plain = tkt.SolverConfig(kmax=q["kmax"], tol=q["tol"], orth="lanczos")
    mid, runs = dict(d=q["d"], n=q["n"], kappa=q["kappa"], m=q["m"], kmax=q["kmax"], tol=q["tol"]), {}
    for storage in ("full", "twopass"):
        runs[storage] = run_solve(tkt, op, b, plain, "solve_deflated", basis=basis, storage=storage)
    (rf, _, cf), (rt, _, ct) = runs["full"], runs["twopass"]
    k = rf.niterations
    x_diff = float((rt.x.factors - rf.x.factors).abs().max() / rf.x.factors.abs().max())
    # T and b̃ of the two storages' first passes, from their shared step (not the main path's launches)
    U = torch.tensor(basis.U, device=dev)
    b_perp = deflation_project(b, U)
    states = [deflate_light._init_state(b_perp, q["kmax"] + 1) for _ in range(2)]
    V = torch.zeros((k + 1, q["d"], q["n"]), dtype=torch.float64, device=dev)
    V[0] = states[0].vp
    deflate_light._advance(op, states[0], b_perp, U, 1, k + 1, V=V)
    deflate_light._advance(op, states[1], b_perp, U, 1, k + 1, measure_leak=True)
    t_equal = all(torch.equal(getattr(states[0], f), getattr(states[1], f)) for f in ("dg", "od", "btil"))
    del V, states
    mid["full"] = deflated_summary(rf, runs["full"][1], cf, dev)
    mid["twopass"] = dict(deflated_summary(rt, runs["twopass"][1], ct, dev), x_max_rel_diff_vs_full=x_diff,
                          dg_od_btil_bit_equal=t_equal)
    require((rt.status, rt.niterations) == (rf.status, k), f"deflated mid: twopass {rt.status}/{rt.niterations} "
                                                           f"vs full {rf.status}/{k}")
    require(t_equal and rt.certified_bound == rf.certified_bound and rt.relative_residual == rf.relative_residual,
            f"deflated mid: twopass's T equal {t_equal}, bounds {rt.certified_bound} vs {rf.certified_bound}")
    require(x_diff <= DEFLATED_X_RTOL, f"deflated mid: twopass x differs from full's by {x_diff}")
    require(cf == {"banded_spmv": k + xc} and ct == {"banded_spmv": 2 * k - 1 + xc},
            f"deflated mid: launches full {cf}, twopass {ct} in {k} steps (want {k + xc}, {2 * k - 1 + xc})")
    launched += cf["banded_spmv"] + ct["banded_spmv"]

    res, wall, counts = run_solve(tkt, op, b, tkt.SolverConfig(kmax=q["kmax"], tol=q["tol"]), "solve_deflated",
                                  basis=basis, storage="segmented", segment=q["segment"])
    mid["segmented"] = dict(segment=q["segment"], **deflated_summary(res, wall, counts, dev))
    require(res.boundary_drift_max is not None and math.isfinite(res.certified_bound[-1])
            and counts == {"banded_spmv": res.niterations + xc},
            f"deflated mid segmented: bound {res.certified_bound}, drift {res.boundary_drift_max}, "
            f"launches {counts}")
    launched += counts["banded_spmv"]

    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "state.npz")
        res, wall, counts = run_solve(tkt, op, b, plain, "solve_deflated", basis=basis, storage="twopass",
                                      checkpoints=q["stop"], state_cache=cache)
        launched += counts["banded_spmv"]
        res, wall, counts = run_solve(tkt, op, b, plain, "solve_deflated", basis=basis, storage="twopass",
                                      state_cache=cache)
    stop = max(q["stop"])
    want = (k - stop) + (k - 1) + xc
    mid["resumed"] = dict(stopped_at=stop, **deflated_summary(res, wall, counts, dev))
    require(res.certified_bound == rt.certified_bound and torch.equal(res.x.factors, rt.x.factors),
            f"deflated mid: the resumed twopass differs from the uninterrupted one ({res.certified_bound} vs "
            f"{rt.certified_bound})")
    require(counts == {"banded_spmv": want}, f"deflated mid resumed: launches {counts}, want {want}")
    launched += counts["banded_spmv"]
    out["mid"] = mid
    del runs, rf, rt, res, op, b, basis, U, b_perp

    # (c) card against CPU
    q = p["small"]
    got = {}
    for d_ in (dev, torch.device("cpu")):
        op = tkt.laplace(3, q["n"], shift=q["shift"], device=d_)
        b = tkt.random_rhs(3, q["n"], seed=q["seed"]).to(d_)
        got[d_.type] = run_solve(tkt, op, b, tkt.SolverConfig(**q["config"]), "solve_deflated", m=q["m"],
                                 checkpoints=q["checkpoints"])
        if d_.type == dev.type:
            launched += got[d_.type][2].get("banded_spmv", 0)
            oracle = tkt.kron_residual_dense(op, got[d_.type][0].x, b)
    g, c = got[dev.type][0], got["cpu"][0]
    bound_err = max(abs(a - r) / r for a, r in zip(g.certified_bound, c.certified_bound))
    out["card_vs_cpu"] = dict(n=q["n"], m=q["m"], status=g.status, niterations=g.niterations,
                              certified_bound=g.certified_bound, bound_max_rel_err=bound_err,
                              bound_rtol=DEFLATED_BOUND_RTOL, dense_oracle_residual=oracle)
    require((g.status, g.niterations, g.checkpoints) == (c.status, c.niterations, c.checkpoints),
            f"deflated card vs cpu: {g.status}/{g.niterations} vs {c.status}/{c.niterations}")
    require(bound_err <= DEFLATED_BOUND_RTOL, f"deflated card vs cpu: bounds differ by {bound_err}")
    require(oracle <= g.certified_bound[-1] + 1e-14, f"deflated: dense oracle {oracle} above the bound")
    emit("deflated", **out, seconds=time.perf_counter() - t_phase)
    return launched


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
        worst, times, extra = phase_kernels(tkt)
        phase_golden(tkt)
        launches, slice_trace = phase_slice(tkt)
        phase_card_vs_cpu(tkt)
        launches["resident_lanczos"] = phase_host_projected(tkt)
        launches["resident_spmv"] = phase_entry_points(tkt, slice_trace)
        ring_launches, ring_times, worst["ring_spmv"] = phase_sharded(tkt)
        phase_solvers(tkt)
        launches["banded_spmv"] += phase_deflated(tkt)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    pkg = "tensorkrylov_tpu_torch/ops/csrc"
    replaces = {"banded_spmv": "banded_spmv.py:36", "fused_lanczos": "fused_lanczos.py:58",
                "resident_lanczos": "resident_lanczos.py:51", "resident_spmv": "resident_spmv.py:42"}
    kernels = [dict(name=name, route="cuda", source=f"{pkg}/{name}.cu",
                    replaces=f"tensorkrylov_tpu/ops/pallas/{where}", launches=launches[name],
                    max_abs_err=worst[name], ms=times[name][0], plain_ms=times[name][1],
                    **{k: v for k, v in extra[name].items() if k not in ("bytes", "flops")})
               for name, where in replaces.items()]
    kernels.append(dict(name="ring_spmv", route="cuda", source=f"{pkg}/ring_spmv.cu",
                        replaces="tensorkrylov_tpu/ops/pallas/ring_spmv.py:45", launches=ring_launches["ring_spmv"],
                        max_abs_err=worst["ring_spmv"], ms=ring_times["ring_ms"], plain_ms=ring_times["plain_ms"],
                        bound_ms=ring_times["bound_ms"], bound_by=ring_times["bound_by"],
                        library_ms=ring_times["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
