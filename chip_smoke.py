#!/usr/bin/env python3
"""Time each CUDA kernel of the PyTorch port (tensorkrylov_tpu_torch) alone on one NVIDIA H100.

    python3 chip_smoke.py                   # the kernels of this checkout
    python3 chip_smoke.py --roots OTHER .   # two checkouts, each in processes of its own: OTHER, ., ., OTHER

Each kernel is first held against its plain PyTorch version on the inputs it
is then timed on, bit for bit (the Hessenberg eigensolver, which no plain
version matches bit for bit, by its residual and its eigenvalues against the
plain version's); a failed gate exits 1 and prints no result line, as does a
machine without CUDA. CUDA events after warm-up then time the kernel, its
plain version on the card, a library call that computes the same where one
exists, and the kernel's bound: the larger of its bytes over 3.35 TB/s and
its operations over the peak rate of its type (67 TFLOP/s f32 and 34 TFLOP/s
f64 outside the tensor cores; NVIDIA's H100 SXM data sheet).

Then each entry that launches the kernels runs once at its benchmark cell's
widths, its launch counts set to 0 just before it and read just after
(main_paths).

Lines, one JSON object each: the device (with nvidia-smi's name and power
limit), the build (nvcc seconds, ptxas registers and spills), one line per
kernel at the main path's shapes with its cluster, placement and lane
sweeps, one line per main-path entry, then {"kernels": [...]} (`launches`:
a kernel's launches over the main-path entries, `launched_by` them one by
one; hess_eig's `checks`: the Arnoldi solve's) and last {"ok": true,
"device": {...}}. With --roots, each process prints
those lines and the last line is {"roots": {root: [kernels, kernels]}}.

Correctness on the card is tests/test_torch_cuda.py's
(python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q);
a solve's time, memory and profile are the benchmark's (tkbench/).
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LIMITS = {torch.float64: 1e-12, torch.float32: 1e-5}  # a library call against the kernel, relative
HBM_BYTES_PER_S = 3.35e12                                     # H100 SXM device memory
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 34e12}    # outside the tensor cores
D, N = 10, 131072         # the main path's shape
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # the cluster kernels' blocks per factor, swept
LANES = (2, 4, 8, 16, 32)         # the tridiagonal kernel's lanes per eigenvalue, swept
STEPS = 8                 # resident Lanczos steps per call at the main path's shape (the host-projected segment)
BENCH_STEPS = 32          # resident steps per call at the bench's shape: the bench's longest call
APPLIES = 200             # applies per multi-apply call: the bench's m1
SHARDS = 4                # the ring kernel's mode shards, all on cuda:0
W_PLACEMENTS = {"shared": None, "u_row": 0}  # the fused kernel's w: where its plan puts it, and forced into u's row
# the κ = 1e2 slice's last check, and the flagship's deciding checkpoint
TRIDIAG = dict(slice_K=201, slice_k=29, flagship=dict(K=513, k=384, kappa=1e6))
EXPSUM_ROW = (1.05e6, 0.5e-8 / 1.05e6)  # the deflated cells' row: κ ≈ 1.05e6, coefficients at 0.5·tol/κ (rank 47)
SLICE = dict(kmax=200, tol=1e-8)  # the κ = 1e2 cells' solve
HOST = dict(SLICE, orth="lanczos", basis_dtype=torch.float32, check_every=8, step_impl="resident")
FLAGSHIP = dict(kappa=1e6, m=2048, checkpoints=[384, 448, 512],   # the κ = 1e6 cells' deflated solve
                config=dict(kmax=512, tol=1e-8, orth="lanczos_reorth_auto"))
ARNOLDI = dict(kmax=384, tol=1e-8, orth="arnoldi", tmax=513, check_every=16)  # the Arnoldi cell's solve
HESS = dict(c=10.0, kappa=1e4, K=385, steps=304, ks=(16, 64, 128, 304), plain_k=16, res_limit=1e-12, w_limit=1e-10)
GRAM_P = 95               # the deflated cells' cross-check columns: R + 2t = 1 + 2·47 (the coefficients' rank 47)
F64_INSTR_PER_S = 132 * 64 * 1.98e9   # the f64 pipes issuing one instruction a lane a clock: 16.7e12/s


class Failed(Exception):
    pass


def emit(line, **fields):
    print(json.dumps({"line": line, **fields}), flush=True)


def gate(what, got, ref):
    """Raise Failed unless got equals ref bit for bit (tensors, or tuples of
    them); returns the largest difference, 0.0."""
    pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
    torch.cuda.synchronize()
    err = max((float((g - r).abs().max()) for g, r in pairs if g.numel()), default=0.0)
    if err != 0.0 or not all(torch.equal(g, r) for g, r in pairs):
        raise Failed(f"{what} differs from its plain version by {err}")
    return err


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


def scaled_laplace(tkt, d, n, device):
    """laplace(d, n) scaled to unit spectral radius per factor."""
    op = tkt.laplace(d, n, device=device)
    return tkt.KroneckerSumOperator(op.bands / (4.0 * (n + 1) ** 2), op.offsets)


def rd_problem(tkt, n, kappa, device):
    """reaction_diffusion(10, n, σ for κ) and a unit-row b from random_rhs
    seed 1234, made on the CPU and copied: the κ = 1e2 and κ = 1e6 cells'
    problem."""
    op = tkt.reaction_diffusion(D, n, sigma_for_kappa(n, kappa), device="cpu")
    b = tkt.random_rhs(D, n, seed=1234)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    return tkt.KroneckerSumOperator(op.bands.to(device), op.offsets), b.to(device)


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


def time_pair(fn_plain, fn_kernel, reps=200, warm=20):
    """ms per call of the kernel and of the plain version, each the mean of
    two runs in the order plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_one(fn, reps, warm) for fn in (fn_plain, fn_kernel, fn_kernel, fn_plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def host_ms(fn, reps):
    """ms per call of fn on the host's clock, the card synchronized at the end."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


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


def library_spmv_ms(op, v, ref):
    """ms of one torch.sparse CSR matvec of the d factors as one block-diagonal
    (d·n) × (d·n) matrix (the library yardstick; the port never calls it),
    after checking that it computes ref."""
    d, nb, n = op.bands.shape
    dev = op.device
    cols = torch.arange(n, device=dev)[:, None] + op.offsets_tensor[None, :]        # (n, nb)
    valid = (cols >= 0) & (cols < n)
    crow = torch.zeros(d * n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(valid.sum(1).repeat(d), 0)
    col = cols[None] + (torch.arange(d, device=dev) * n)[:, None, None]            # (d, n, nb)
    keep = valid[None].expand(d, n, nb)
    x = v.reshape(-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        A = torch.sparse_csr_tensor(crow, col[keep], op.bands.permute(0, 2, 1)[keep], size=(d * n, d * n),
                                    check_invariants=False)
        err = float(((A @ x).reshape(v.shape) - ref).abs().max() / ref.abs().max())
        if err > LIMITS[v.dtype]:
            raise Failed(f"the torch.sparse CSR matvec differs from the SpMV by {err}")
        return time_one(lambda: A @ x)


def graph_replay_ms(fn, ref):
    """ms per replay of fn's work captured in a CUDA graph: its launches
    without the host's Python around them, after checking that a replay
    gives ref's bits."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    gate("a replay of the call's CUDA graph", tuple(out), tuple(ref))
    return time_one(graph.replay)


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


def device_line():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else None
    emit("device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda)
    return name


def build_line():
    from tensorkrylov_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.kernels()
    report = [ln.strip() for ln in _build.build_info["log"].splitlines()
              if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_info["seconds"],
         library=_build.build_info["path"], ptxas=report)


def time_banded_spmv(tkt, dev):
    """The SpMV at d=10, n=131072, f64, tridiagonal, beside torch.sparse."""
    from tensorkrylov_tpu_torch.ops.banded import spmv, spmv_reference

    op = scaled_laplace(tkt, D, N, dev)
    v = unit_rows(np.random.default_rng(12), (D, N), torch.float64, dev)
    ref = spmv_reference(op, v)
    err = gate("banded_spmv", spmv(op, v), ref)
    ms, plain_ms = time_pair(lambda: spmv_reference(op, v), lambda: spmv(op, v))
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_spmv_ms(op, v, ref), **bound(*spmv_work(op, v), torch.float64))
    emit("banded_spmv", d=D, n=N, dtype="float64", **row)
    return row


def time_fused(tkt, dev):
    """The fused Lanczos core at d=10, n=131072, f64: the call and its launch
    alone (a CUDA-graph replay) with w where its plan puts it and in u's row,
    and the launch alone at every cluster size G."""
    from tensorkrylov_tpu_torch.ops.fused_lanczos import (
        fused_lanczos_core, fused_lanczos_core_reference, fused_lanczos_plan)

    op = scaled_laplace(tkt, D, N, dev)
    rng = np.random.default_rng(12)
    v, v_pprev, b = (unit_rows(rng, (D, N), torch.float64, dev) for _ in range(3))
    beta = torch.full((D,), 0.5, dtype=torch.float64, device=dev)
    call = lambda: fused_lanczos_core(op, v, v_pprev, beta, b)
    ref = tuple(fused_lanczos_core_reference(op, v, v_pprev, beta, b))
    err = gate("fused_lanczos", tuple(call()), ref)
    ms, plain_ms = time_pair(lambda: fused_lanczos_core_reference(op, v, v_pprev, beta, b), call)
    placements = {"G": fused_lanczos_plan(D, N, torch.float64, dev)}
    for placement, w_bytes in W_PLACEMENTS.items():
        with fused_setting(w_shared_bytes=w_bytes):
            gate(f"fused_lanczos, w in {placement}", tuple(call()), ref)
            placements[placement] = dict(ms=time_one(call), device_ms=graph_replay_ms(call, ref))
    by_G = {}
    for G in CLUSTER_SIZES:
        with fused_setting(G):
            gate(f"fused_lanczos, G={G}", tuple(call()), ref)
            by_G[G] = graph_replay_ms(call, ref)
    e, nb, nnz = 8, len(op.offsets), op.nnz_per_factor
    # reads bands, v_prev, v_pprev, b, β; writes u, α, β², ⟨u, b⟩
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=None, device_ms=placements["shared"]["device_ms"],
               **bound((nb + 4) * D * N * e + 4 * D * e, D * (2 * nnz + 10 * N), torch.float64))
    emit("fused_lanczos", d=D, n=N, dtype="float64", placements=placements, device_ms_by_G=by_G, **row)
    return row


def time_resident_lanczos(tkt, dev):
    """The resident multi-step Lanczos kernel (f32 only): STEPS steps from a
    unit start at d=10, n=131072, at the plan's G and at every G with u in
    shared memory where it fits and always in the scratch row (L2); and
    BENCH_STEPS steps on the bench's own d=8, n=2^20 inputs at every G."""
    from tensorkrylov_tpu_torch import bench
    from tensorkrylov_tpu_torch.ops import resident_lanczos as rl

    op = scaled_laplace(tkt, D, N, dev).astype(torch.float32)
    v = unit_rows(np.random.default_rng(12), (D, N), torch.float64, dev).float()
    start = (v, torch.zeros_like(v), torch.zeros(D, dtype=torch.float32, device=dev))
    call = lambda: rl.lanczos_resident_steps(op, *start, STEPS)
    ref = tuple(rl.lanczos_resident_steps_reference(op, *start, STEPS))
    err = gate("resident_lanczos", tuple(call()), ref)
    ms, plain_ms = time_pair(lambda: rl.lanczos_resident_steps_reference(op, *start, STEPS), call, reps=50, warm=5)
    clusters = dict(plan=rl.resident_lanczos_plan(D, N, dev),
                    clusters_that_fit={G: rl._max_active_clusters(G, dev.index or 0, rl._u_bytes(N, G))
                                       for G in CLUSTER_SIZES})
    for key, u_bytes in (("ms", None), ("ms_u_in_l2", 0)):
        clusters[key] = {}
        for G in CLUSTER_SIZES:
            with resident_setting(G, u_bytes):
                gate(f"resident_lanczos, G={G}, {key}", tuple(call()), ref)
                clusters[key][G] = time_one(call, reps=50, warm=5)

    bop, _, _ = bench._spmv_problem(dev, bench.SPMV_D, bench.SPMV_N)
    vp = bench._unit_start(bench.SPMV_D, bench.SPMV_N, dev)
    bstart = (vp, torch.zeros_like(vp), torch.zeros(bench.SPMV_D, dtype=torch.float32, device=dev))
    bcall = lambda: rl.lanczos_resident_steps(bop, *bstart, BENCH_STEPS)
    bref = tuple(rl.lanczos_resident_steps_reference(bop, *bstart, BENCH_STEPS))
    gate("resident_lanczos at the bench's shape", tuple(bcall()), bref)
    bench_ms = time_pair(lambda: rl.lanczos_resident_steps_reference(bop, *bstart, BENCH_STEPS), bcall,
                         reps=3, warm=1)
    bench_by_G = {}
    for G in CLUSTER_SIZES:
        with resident_setting(G):
            gate(f"resident_lanczos at the bench's shape, G={G}", tuple(bcall()), bref)
            bench_by_G[G] = time_one(bcall, reps=3, warm=1)
    del bref
    nb, nnz = len(op.offsets), op.nnz_per_factor
    # f32, STEPS steps: reads bands, vp, vpp, β; writes V (S, d, n), α, β (d, S), β_last
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=None, **bound(((nb + 2 + STEPS) * D * N + (2 * STEPS + 2) * D) * 4,
                                        STEPS * D * (2 * nnz + 9 * N), torch.float32))
    emit("resident_lanczos", d=D, n=N, dtype="float32", steps=STEPS, clusters=clusters,
         bench_shape=dict(d=bench.SPMV_D, n=bench.SPMV_N, steps=BENCH_STEPS, ms=bench_ms[0], plain_ms=bench_ms[1],
                          G=rl.resident_lanczos_plan(bench.SPMV_D, bench.SPMV_N, dev), ms_by_G=bench_by_G), **row)
    return row


def time_resident_spmv(tkt, dev):
    """The multi-apply SpMV, APPLIES applies at the bench's d=8, n=2^20, in f32
    and f64, through each instantiation: laplace (centred 3 bands), a distinct
    pentadiagonal operator (centred 5 bands, and forced onto the generic one)
    and a distinct 7-band operator (generic)."""
    from tensorkrylov_tpu_torch import bench
    from tensorkrylov_tpu_torch.ops.resident_spmv import (
        resident_spmv_plan, spmv_multi_apply, spmv_multi_apply_reference)

    d, n, m = bench.SPMV_D, bench.SPMV_N, APPLIES
    lap, penta = tkt.laplace(d, n, device=dev), banded_operator(tkt, d, n, 2, 17, dev)
    cases = (("laplace", lap, 1.0 / (4.0 * (n + 1) ** 2), contextlib.nullcontext),
             ("penta", penta, 0.125, contextlib.nullcontext), ("penta_generic", penta, 0.125, generic_spmv),
             ("seven", banded_operator(tkt, d, n, 3, 6, dev), 0.1, contextlib.nullcontext))
    runs, err = {}, 0.0
    for case, op64, c, setting in cases:
        for dtype in (torch.float32, torch.float64):
            op = op64.astype(dtype)
            v = unit_rows(np.random.default_rng(15), (d, n), dtype, dev)
            ref = spmv_multi_apply_reference(op, v, m, c)
            with setting():
                err = max(err, gate(f"resident_spmv {case} {dtype}", spmv_multi_apply(op, v, m, c), ref))
                M, T = resident_spmv_plan(op)
                ms, plain_ms = time_pair(lambda: spmv_multi_apply_reference(op, v, m, c),
                                         lambda: spmv_multi_apply(op, v, m, c), reps=3, warm=1)
            runs[f"{case}_{str(dtype)[6:]}"] = dict(ms=ms, plain_ms=plain_ms, M=M, T=T)
            del ref
    flops = m * d * (2 * lap.nnz_per_factor + n)
    f32, f64 = runs["laplace_float32"], runs["laplace_float64"]
    # f32: reads bands and v once, writes u once; m applies of the SpMV and the scaling
    row = dict(max_abs_err=err, ms=f32["ms"], plain_ms=f32["plain_ms"], library_ms=None,
               ms_float64=f64["ms"], plain_ms_float64=f64["plain_ms"],
               **bound((len(lap.offsets) + 2) * d * n * 4, flops, torch.float32))
    # the floor under the kernel's rounding contract: each operation on its own at half the peak rate
    # (the peak counts an FMA as two); computed, not measured
    emit("resident_spmv", d=d, n=n, applies=m, runs=runs,
         computed_no_fma_floor_ms=flops / (PEAK_FLOP_S[torch.float32] / 2) * 1e3, **row)
    return row


def time_ring(tkt, dev):
    """The ring SpMV, one launch for the 4 mode shards of d=10, n=131072, f64
    on cuda:0, beside its launch alone (a CUDA-graph replay), the gspmd route,
    the unsharded banded_spmv and torch.sparse."""
    from tensorkrylov_tpu_torch.ops.banded import spmv
    from tensorkrylov_tpu_torch.ops.ring_spmv import ring_spmv_reference
    from tensorkrylov_tpu_torch.parallel import make_mesh, shard_operator, shard_rhs
    from tensorkrylov_tpu_torch.parallel.halo import exchange_halos, spmv_sharded

    def plain(sop, vs):
        """The halo exchange, then ring_spmv_reference on every shard."""
        halos, _ = exchange_halos(sop, vs)
        return [ring_spmv_reference(sh.op, v, lh, rh) for sh, v, (lh, rh) in zip(sop.shards, vs, halos)]

    mesh = make_mesh(devices=[dev] * SHARDS)
    op, _ = rd_problem(tkt, N, 1e2, dev)
    v = unit_rows(np.random.default_rng(16), (D, N), torch.float64, dev)
    sop, vs = shard_operator(op, mesh, "ring"), shard_rhs(v, mesh)
    ref = tuple(plain(sop, vs))
    err = gate("ring_spmv", tuple(spmv_sharded(sop, vs)), ref)
    ms, plain_ms = time_pair(lambda: plain(sop, vs), lambda: spmv_sharded(sop, vs))
    gspmd = shard_operator(op, mesh, "gspmd")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_spmv_ms(op, v, spmv(op, v)), **bound(*spmv_work(op, v), torch.float64))
    emit("ring_spmv", d=D, n=N, shards=SHARDS, dtype="float64", graph_replay_ms=graph_replay_ms(
        lambda: spmv_sharded(sop, vs), ref), gspmd_route_ms=time_one(lambda: spmv_sharded(gspmd, vs)),
         unsharded_banded_spmv_ms=time_one(lambda: spmv(op, v)), **row)
    return row


def lanczos_H(op, b, steps):
    """H (d, steps+1, steps+1) after `steps` reorthogonalized f64 Lanczos steps."""
    from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_step

    st, _ = init_state(op, b, steps, torch.float64)
    for k in range(1, steps + 1):
        st, _ = lanczos_step(op, st, b, k, reorth=True, proj_dtype=torch.float64)
    return st.H


def time_tridiag(tkt, dev):
    """The tridiagonal eigensolver on the κ = 1e2 slice's own Lanczos T at its
    last check (K=201, k=29), on the flagship operator's at K=513, k=384 and
    on the slice's first factor alone (d=1): each beside Newton–Schulz after
    it, its plain version, torch.linalg.eigh of the padded batch that
    masked_eigh hands it and masked_eigh itself, and at every pair of lanes P
    and cluster size G."""
    from tensorkrylov_tpu_torch.ops.eigen import (_tridiag_eigh_cuda, masked_eigh, masked_eigh_tridiag_mixed,
                                                  masked_eigh_tridiag_reference, tridiag_cluster, tridiag_eigh,
                                                  tridiag_lanes, tridiag_rounds)

    q = TRIDIAG["flagship"]
    op, b = rd_problem(tkt, N, 1e2, dev)
    H_slice = lanczos_H(op, b, TRIDIAG["slice_K"] - 1)
    op = tkt.reaction_diffusion(D, N, sigma_for_kappa(N, q["kappa"]), device=dev)
    H_flag = lanczos_H(op, unit_rows(np.random.default_rng(1234), (D, N), torch.float64, dev), q["K"] - 1)
    del op, b
    cases = {"slice_K201_k29": (H_slice, TRIDIAG["slice_k"]), "flagship_K513_k384": (H_flag, q["k"]),
             "slice_d1_K201_k29": (H_slice[:1].contiguous(), TRIDIAG["slice_k"])}
    out, err = {}, 0.0
    for case, (H, k) in cases.items():
        dd, K = H.shape[0], H.shape[1]
        stats = {}
        ref = tuple(masked_eigh_tridiag_reference(H, k, stats=stats))
        err = max(err, gate(f"tridiag_eigh {case}", tuple(tridiag_eigh(H, k)), ref))
        P = tridiag_lanes(dd, k)
        plan = dict(P=P, rounds=tridiag_rounds(P), G=tridiag_cluster(dd, k, P, H.dtype, dev))
        by_P_G = {}
        for lanes in LANES:
            ref_p = tuple(masked_eigh_tridiag_reference(H, k, lanes=lanes))
            by_P_G[lanes] = {}
            for G in CLUSTER_SIZES:
                gate(f"tridiag_eigh {case}, P={lanes}, G={G}", tuple(_tridiag_eigh_cuda(H, k, True, lanes=lanes,
                                                                                        cluster=G)), ref_p)
                by_P_G[lanes][G] = time_one(lambda: _tridiag_eigh_cuda(H, k, True, lanes=lanes, cluster=G),
                                            reps=20, warm=2)
        kernel_ms, plain_ms = time_pair(lambda: masked_eigh_tridiag_reference(H, k), lambda: tridiag_eigh(H, k),
                                        reps=1 if K > 300 else 3, warm=1)
        # the padded batch of masked_eigh: the active block, zero coupling, H[s, 0, 0] on the padded diagonal
        m = (torch.arange(K, device=dev) < k).to(H.dtype)
        Wm = H * m[None, :, None] * m[None, None, :]
        Wm = 0.5 * (Wm + Wm.transpose(1, 2)) + torch.diag_embed((1.0 - m)[None, :] * H[:, 0, 0][:, None])
        # bytes: T's 2k − 1 entries a factor read, w and Q written; operations from the plain version's count of
        # what this input needs (bisection-equivalent halvings, inverse-iteration solves, Gram–Schmidt)
        nbytes = 8 * (dd * (2 * k - 1) + dd * K + dd * K * K)
        flops = (stats["halvings"] * (3 * k + 2) + stats["solves"] * dd * k * (13 * k + 1)
                 + stats["mgs_pairs"] * (4 * k - 1) + stats["mgs_members"] * 3 * k)
        out[case] = dict(d=dd, K=K, k=k, plan=plan, kernel_ms=kernel_ms,
                         plain_ms=plain_ms, kernel_ms_200=time_one(lambda: tridiag_eigh(H, k), reps=200, warm=5),
                         with_newton_schulz_ms=time_one(lambda: masked_eigh_tridiag_mixed(H, k), reps=50, warm=5),
                         library_ms=time_one(lambda: torch.linalg.eigh(Wm), reps=20, warm=3),
                         dense_masked_eigh_ms=time_one(lambda: masked_eigh(H, k), reps=20, warm=3),
                         halvings=stats["halvings"], probes=stats["probes"], ms_by_P_G=by_P_G,
                         **bound(nbytes, flops, torch.float64))
    s = out["slice_K201_k29"]
    row = dict(max_abs_err=err, ms=s["kernel_ms_200"], plain_ms=s["plain_ms"],
               bound_ms=s["bound_ms"], bound_by=s["bound_by"], library_ms=s["library_ms"])
    emit("tridiag_eigh", dtype="float64", cases=out)
    return row


def time_expsum_sup(tkt, dev):
    """The deflated certificate's exp-sum sup error on the 200 000-point grid
    at the deflated cells' row: the kernel, the call with its 8-byte read, the
    plain version on the card and the host longdouble function."""
    from tensorkrylov_tpu_torch import deflate
    from tensorkrylov_tpu_torch.coeffs.tables import load_tables, select_bh
    from tensorkrylov_tpu_torch.ops import expsum

    kappa, tol = EXPSUM_ROW
    co = select_bh(torch.tensor(kappa, dtype=torch.float64), tol, load_tables())
    om, al = expsum._terms(co.omega, co.alpha)
    h = expsum._grid_step(kappa, expsum.N_GRID)
    got = expsum.expsum_sup_error_dd(co.omega, co.alpha, kappa, expsum.N_GRID, device=dev)
    plain = float(expsum._sup_residuals(om, al, h, expsum.N_GRID, dev).max())
    if got != plain:
        raise Failed(f"expsum_sup differs from its plain version: {got!r} vs {plain!r}")
    row = dict(max_abs_err=abs(got - plain),
               ms=time_one(lambda: expsum._sup_cuda(om, al, h, expsum.N_GRID, dev)),
               call_ms=host_ms(lambda: expsum.expsum_sup_error_dd(co.omega, co.alpha, kappa, expsum.N_GRID,
                                                                  device=dev), 200),
               plain_ms=time_one(lambda: expsum._sup_residuals(om, al, h, expsum.N_GRID, dev), reps=3, warm=1),
               host_ms=host_ms(lambda: deflate.expsum_sup_error(co.omega, co.alpha, kappa, expsum.N_GRID), 2),
               rank=int(co.rank), kappa=kappa,
               **bound(8 + 2 * 8 * int(om.numel()), expsum.expsum_sup_ops(co.omega, co.alpha, kappa, expsum.N_GRID),
                       torch.float64))
    emit("expsum_sup", coeff_tol=tol, sup=got, **row)
    return row


def time_hess_eig(tkt, dev):
    """The Hessenberg eigensolver on Arnoldi's H of the Arnoldi cell's
    operator (conv_diff, d=10, n=131072, κ = 1e4; K=385, 304 steps) at
    k = 16, 64, 128, 304: the launch, the call with V = Z·X, the operations
    the kernel counts, torch.linalg.eig of the active block; the padded
    (10, 385, 385) eig and the plain version on the card at k=16."""
    from tensorkrylov_tpu_torch.ops import hess_eig as he
    from tensorkrylov_tpu_torch.ops.orth import arnoldi_step, init_state

    op = tkt.conv_diff(D, N, c=HESS["c"], shift=sigma_for_kappa(N, HESS["kappa"]), device=dev)
    b = tkt.random_rhs(D, N, seed=11, identical=False, device=dev)
    st, _ = init_state(op, b, HESS["K"] - 1, torch.float64)
    for k in range(1, HESS["steps"] + 1):
        st, _ = arnoldi_step(op, st, b, k, proj_dtype=torch.float64)
    H = st.H.clone()
    del st, op, b
    torch.cuda.empty_cache()

    def match(w, ref):
        """Largest distance from an eigenvalue of ref to the nearest unused one of w."""
        w, used, worst = w.cpu().numpy(), np.zeros(w.numel(), bool), 0.0
        for z in ref.cpu().numpy():
            dist = np.where(used, np.inf, np.abs(w - z))
            j = int(np.argmin(dist))
            used[j] = True
            worst = max(worst, float(dist[j]))
        return worst

    rows = []
    for k in HESS["ks"]:
        w, Z, X, info, stats = he._hess_eig_cuda(H, k, stats=True)
        V = he._vectors(Z, X)[0]
        A = torch.triu(H[:, :k, :k], -1)
        nrm = torch.linalg.matrix_norm(A)
        res = float((torch.linalg.matrix_norm(A.to(V.dtype) @ V - V * w[:, None, :]) / nrm).max())
        pw = he._hess_eig_plain(H[:1].cpu(), k)[0]
        w_err = max(match(w[0], pw[0]) / float(nrm[0]),
                    max(match(w[f], torch.linalg.eigvals(A[f])) / float(nrm[f]) for f in range(D)))
        if bool(info.any()) or res > HESS["res_limit"] or w_err > HESS["w_limit"]:
            raise Failed(f"hess_eig k={k}: info {info.tolist()}, residual {res}, eigenvalues off by {w_err}")
        Ak = A.contiguous()
        rows.append(dict(k=k, residual=res, w_err=w_err,
                         iterations=stats[:, 0].tolist(), bulge_steps=stats[:, 1].tolist(),
                         kernel_ms=time_one(lambda: he._hess_eig_cuda(H, k), reps=5, warm=1),
                         ms=time_one(lambda: he.hess_eig(H, k), reps=5, warm=1),
                         library_ms=time_one(lambda: torch.linalg.eig(Ak), reps=2, warm=1),
                         **bound(0, int(stats[:, 2].sum()), torch.float64)))
    Hm = torch.triu(H, -1)
    padded_ms = time_one(lambda: torch.linalg.eig(Hm), reps=2, warm=1)
    Hp = H[:, :HESS["plain_k"] + 1, :HESS["plain_k"] + 1].contiguous()
    plain_ms = host_ms(lambda: he.hess_eig_reference(Hp, HESS["plain_k"]), 1)
    top = rows[-1]
    row = dict(k=top["k"], ms=top["ms"], kernel_ms=top["kernel_ms"],
               bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=top["library_ms"],
               padded_library_ms=padded_ms, plain_ms=plain_ms, plain_k=HESS["plain_k"],
               max_residual=max(r["residual"] for r in rows))
    emit("hess_eig", d=D, K=HESS["K"], rows=rows, **row)
    return row


def time_gram_dot2(tkt, dev):
    """The deflated cells' compensated Gram of the cross-check's columns,
    d=10, P=95, n=131072: the kernel gated bit for bit against the plain
    version on the card, both timed; the bound counts 11 f64 operations a
    needed product (i <= j; an FMA as two), and issue_floor_ms the kernel's 10
    f64 instructions a product at one a lane a clock."""
    from tensorkrylov_tpu_torch.ops import gram_dot2 as gd

    C = torch.randn((D, GRAM_P, N), dtype=torch.float64, device=dev, generator=torch.Generator(dev).manual_seed(13))
    bits = lambda pair: tuple(t.view(torch.int64) for t in pair)
    err = gate("gram_dot2", bits(gd._gram_dot2_cuda(C)), bits(gd.gram_dot2_plain(C)))
    torch.cuda.empty_cache()
    products = D * N * GRAM_P * (GRAM_P + 1) // 2
    row = dict(max_abs_err=err, ms=time_one(lambda: gd._gram_dot2_cuda(C), reps=20, warm=3),
               plain_ms=time_one(lambda: gd.gram_dot2_plain(C), reps=2, warm=1),
               issue_floor_ms=10 * products / F64_INSTR_PER_S * 1e3,
               **bound(C.numel() * 8 + 2 * 8 * D * GRAM_P ** 2, 11 * products, torch.float64))
    emit("gram_dot2", d=D, P=GRAM_P, n=N, **row)
    return row


def main_paths(tkt, dev):
    """Drive each entry that launches the kernels, at its benchmark cell's
    widths (d=10, n=131072), with the launch counts set to 0 just before it
    and read just after: solve on the κ = 1e2 slice (the default route and
    the fused one) and solve_host_projected on it (the resident route),
    solve_deflated on the κ = 1e6 flagship ('full', 'twopass', and 'twopass'
    over 4 mode shards of the card on the ring route), the Arnoldi cell's
    solve, and the bench (the multi-apply kernel's one caller). Emits one
    line an entry (status, steps, checks, launches, seconds); returns
    {entry: line}."""
    from tensorkrylov_tpu_torch import bench
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.parallel import make_mesh

    out = {}

    def drive(entry, call):
        torch.cuda.synchronize()
        _build.launches.clear()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        line = dict(seconds=time.perf_counter() - t0, launches=dict(_build.launches))
        if not hasattr(res, "niterations"):                # the bench: its exit code
            line.update(rc=res)
        else:
            if isinstance(res.relative_residual, list):    # a deflated solve: its evaluated checkpoints
                checks = len(res.checkpoints)
            else:                                           # the steps at which a check recorded a residual
                r = res.relative_residual.cpu().numpy()
                checks = int((np.isfinite(r) & (r > 0)).sum())
            line.update(status=int(res.status), niterations=res.niterations, checks=checks)
        emit("main_path", entry=entry, **line)
        out[entry] = line

    op, b = rd_problem(tkt, N, 1e2, dev)
    for entry, fields in (("solve", {}), ("solve_fused", dict(orth="lanczos_reorth_auto", step_impl="fused"))):
        drive(entry, lambda: tkt.solve(op, b, tkt.SolverConfig(**SLICE, **fields)))
    drive("solve_host_projected", lambda: tkt.solve_host_projected(op, b, tkt.SolverConfig(**HOST)))
    q = FLAGSHIP
    op, b = rd_problem(tkt, N, q["kappa"], dev)
    basis = tkt.deflation_basis(op, q["m"])
    kw = dict(basis=basis, checkpoints=q["checkpoints"])
    cfg = tkt.SolverConfig(**q["config"])
    for storage in ("full", "twopass"):
        drive(f"solve_deflated_{storage}", lambda: tkt.solve_deflated(op, b, cfg, storage=storage, **kw))
    drive("solve_deflated_twopass_ring4", lambda: tkt.solve_deflated(
        op, b, cfg, storage="twopass", mesh=make_mesh(devices=[dev] * SHARDS), comm="ring", **kw))
    del op, b, basis, kw
    torch.cuda.empty_cache()
    op = tkt.conv_diff(D, N, c=HESS["c"], shift=sigma_for_kappa(N, HESS["kappa"]), device=dev)
    b = tkt.random_rhs(D, N, seed=11, identical=False, device=dev)
    drive("solve_arnoldi", lambda: tkt.solve(op, b, tkt.SolverConfig(**ARNOLDI)))
    del op, b
    torch.cuda.empty_cache()

    def quiet_bench():
        with contextlib.redirect_stdout(io.StringIO()):
            return bench.main([])

    drive("bench", quiet_bench)
    return out


# each kernel's timer, and the TPU kernel or the call it replaces (labels, never opened)
KERNELS = {
    "banded_spmv": dict(timer=time_banded_spmv, replaces="tensorkrylov_tpu/ops/pallas/banded_spmv.py:36"),
    "fused_lanczos": dict(timer=time_fused, replaces="tensorkrylov_tpu/ops/pallas/fused_lanczos.py:58"),
    "resident_lanczos": dict(timer=time_resident_lanczos,
                             replaces="tensorkrylov_tpu/ops/pallas/resident_lanczos.py:51"),
    "resident_spmv": dict(timer=time_resident_spmv, replaces="tensorkrylov_tpu/ops/pallas/resident_spmv.py:42"),
    "ring_spmv": dict(timer=time_ring, replaces="tensorkrylov_tpu/ops/pallas/ring_spmv.py:45"),
    "tridiag_eigh": dict(timer=time_tridiag, replaces="tensorkrylov_tpu/ops/eigen.py:182"),
    "expsum_sup": dict(timer=time_expsum_sup, replaces="none: tensorkrylov_tpu/deflate.py:448 on the host"),
    "hess_eig": dict(timer=time_hess_eig, replaces="none: torch.linalg.eig in ops/expsum.py cp_solve_nonsym_eig "
                                                   "(the JAX package's tensorkrylov_tpu/ops/expsum.py calls "
                                                   "jnp.linalg.eig there)"),
    "gram_dot2": dict(timer=time_gram_dot2, replaces="none: plain PyTorch in ops/gram_dot2.py gram_dot2_plain (the "
                                                     "JAX package's tensorkrylov_tpu/utils/cp.py:246-253 forms the "
                                                     "Gram as an f32-splat pair GEMM)"),
}


def measure(root):
    """Every kernel of the port at `root`, timed; 0, or 1 after a failed gate."""
    sys.path.insert(0, os.path.abspath(root))
    import tensorkrylov_tpu_torch as tkt

    pkg = os.path.dirname(os.path.abspath(tkt.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        print(f"chip_smoke: imported {pkg}, not the package of {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    try:
        name = device_line()
        build_line()
        rows = {kernel: k["timer"](tkt, dev) for kernel, k in KERNELS.items()}
        paths = main_paths(tkt, dev)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for kernel, k in KERNELS.items():
        by_entry = {entry: line["launches"][kernel] for entry, line in paths.items() if kernel in line["launches"]}
        kernels.append(dict(name=kernel, route="cuda", source=f"tensorkrylov_tpu_torch/ops/csrc/{kernel}.cu",
                            replaces=k["replaces"], launches=sum(by_entry.values()), launched_by=by_entry,
                            **rows[kernel]))
        if kernel == "hess_eig":
            kernels[-1]["checks"] = paths["solve_arnoldi"]["checks"]
    print(json.dumps({"kernels": kernels, "root": root}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"), help="two checkouts, timed in the order A, B, B, A")
    ap.add_argument("--root", default=REPO, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    if not args.roots:
        return measure(args.root)
    a, b = args.roots
    runs = {a: [], b: []}
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root], capture_output=True,
                              text=True, timeout=1800)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-6000:])
            return proc.returncode
        runs[root].append(next(json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith('{"kernels"')))
    print(json.dumps({"roots": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
