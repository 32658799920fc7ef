#!/usr/bin/env python3
"""Drive the PyTorch port (tensorkrylov_tpu_torch) once on one NVIDIA H100.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, one output line each:
  1. device  — a CUDA device whose name contains H100 (and the nvidia-smi line);
     tables  — the Braess–Hackbusch tables every solve reads (load_tables' default):
               their path, which must lie inside tensorkrylov_tpu_torch/, sha256, and
               the ms of three load_tables onto the card;
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
               line); the tridiagonal eigensolver (tridiag_eigh) in f64 against its
               plain version, limit 0.0 on w and Q before Newton–Schulz: the slice's
               own Lanczos T (d=10, K=201) at k = 1, 29, 200, 201, the flagship
               operator's at K=513, k=384, Wilkinson's W21+, a plain-Lanczos T
               with ghost copies, the slice's first factor alone (d=1) and a
               two-member cluster split between two blocks of a factor's
               cluster, each with its plan (P lanes, rounds, G, blocks) and
               work (halvings, probes); timed at the slice's last check (K=201,
               k=29), at K=513, k=384 and at d=1 beside torch.linalg.eigh of the
               same padded batch, and at each pair of P and G;
  4. golden  — tests/golden_laplace_d4_n100.json reproduced on the card, and the
               dense-oracle residual at d=3, n=30;
  5. slice   — reaction_diffusion(d=10, n=131072), f64, kmax=200, tol=1e-8, with
               the default step and with the fused step; the kernel launch counts
               must equal the Krylov steps, and eigh_impl must resolve to
               'tridiag_mixed' with one tridiag_eigh launch per check; a third run
               with eigh_impl='dense' holds the default one's traces (residual
               within 1e-7, λ within 1e-12);
  6. card_vs_cpu — the same two solves at d=10, n=4096 on the card and on the CPU,
               both with eigh_impl='tridiag_mixed' (its plain version on the CPU);
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
               cache equal to the uninterrupted one; d=3, n=30 on the card and the CPU
               (both eigh_impl='tridiag_mixed'); the flagship's default run (the
               tridiagonal eigensolver) beside an eigh_impl='dense' run;
 12. recorded — the recorded-relation certificates: the flagship through
               storage='df64', final='device' with the TPU's recipe (phase 11's basis),
               certified below 1e-8 on the measured full Gram, the cross-check not
               contradicting it, one banded_spmv launch (the cross-check's), its bound's
               components beside phase 11's and the TPU's, and the expansion step's
               device operations and ms (its own line, recorded_flagship); config 4
               through solve_block_recorded (m=512, kmax=360), certified below 1e-8 with
               one launch; at the mid shape a df64 solve stopped at checkpoint 64 and
               resumed from its state cache, equal bit for bit to the uninterrupted one;
               eft_selfcheck on the card with defects of 0; both solvers at small sizes
               on the card and the CPU;
 13. sharded_deflated — solve_deflated(mesh=) on 4 mode shards of cuda:0 with phase 11's
               basis: the flagship on storage='twopass', comm='ring' (one ring launch per
               SpMV of both passes), certified below 1e-8, its bound beside phase 11's;
               the flagship on storage='df64', comm='gspmd', final='device', certified
               below 1e-8 within 1e-6 relative of phase 12's bound, its components beside
               phase 12's; both cross-checks not contradicting; the mid shape on 'full'
               with gspmd (4 banded_spmv launches per step) against the unsharded solve,
               the bounds within 1e-9 (beside 1e-15); examples/03_sharded_torch.py; and the nonsymmetric
               runner (experiments/nonsym_scale.py) at the TPU artifact's recipe (d=10,
               n=16384, κ=1e4, kmax=384, tmax=801), unsharded, beside the TPU's numbers
               (one hess_eig launch a check);
 14. sharded_solvers — the JAX dry run's sharded call forms on shard slots of cuda:0:
               config 4 through solve_block(shard_operator(op, mesh, comm), shard_rhs(B,
               mesh, d)) on 4 mode shards, gspmd (4 banded_spmv launches per block step)
               and ring (1 ring launch per block step), each against the unsharded block
               solve; the slice through solve_two_pass(sop, shard_rhs(b, mesh)) on ring (one
               launch per SpMV of both passes) and gspmd (4 per SpMV) against the unsharded
               two-pass; phase 8's rank-2 input through solve_multi_rhs on a (rhs=2,
               factor=1, mode=2) mesh against phase 8's lanes; and every call of
               __graft_entry__.py:dryrun_multichip at its own sizes on 8 slots, a (2, 4) and
               a (2, 2, 2) mesh (experiments/dryrun_multichip.py).
 15. multihost — the multi-process layer: two worker ranks (this script with
               --multihost-worker) on cuda:0 over gloo, 2 shard slots each, through
               init_distributed, make_pod_mesh and distribute_problem. The slice (d=10,
               n=131072, kmax=200, tol=1e-8) in phase 9's layouts 'ring_factor2x2' ('factor'
               across the ranks), 'ring' and 'gspmd' ('mode' across them, the halo between
               slots 1 and 2 crossing), and the mid shape's deflated twopass on the ring
               route: each CONVERGED at one controller's step on 4 slots of cuda:0, with α,
               β, the trace and x bit-equal on both ranks and to it; the ring kernel once per
               rank per SpMV, with a received halo held against its plain version (limit
               0.0); then parallel/_smoke.py as two ranks, their SMOKE lines equal. Per case
               and rank: wall, it/s, peak memory, launches, and the ms per step in halo
               exchange and all-gathers. A rank that fails or passes its timeout ends the
               phase and the other rank;
 16. expsum_sup — the deflated certificate's exp-sum sup error (ops/expsum.py,
               csrc/expsum_sup.cu) at every row of tests/test_torch_expsum_sup.py on the
               full 200 000-point grid: the kernel against its plain version on the card
               (bit for bit) and the host longdouble function (within 1e-17), one launch a
               call; at the flagship's row (κ ≈ 1.05e6, rank 47) the kernel timed with CUDA
               events beside its operations bound, the call with its 8-byte read, the plain
               version on the card and the host function.
 17. hess_eig — the nonsymmetric check's Hessenberg eigensolver (ops/hess_eig.py,
               csrc/hess_eig.cu) on Arnoldi's H of the Arnoldi cell's operator (d=10,
               n=131072, κ=1e4, K=385, 304 steps) at k = 16, 64, 128, 304: one launch,
               info 0, every pair's residual ‖AV − VΛ‖/‖A‖, the eigenvalues against
               torch.linalg.eig of the active block and (first factor) the plain
               version on the CPU; the launch and the call (with V = Z·X) timed with
               CUDA events beside the operations the kernel counts, the plain version
               on the card at k=16, torch.linalg.eig on the active block and on the
               padded (10, 385, 385) stack (library_ms); the main path, the cell's own
               solve (kmax 384, tmax 513, check every 16) on that operator: 19 checks,
               one launch each, no torch.linalg.eig, its true residual on the card
               within tol; and conv_diff(3, 30) through solve against the dense oracle,
               one launch a check.
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
import hashlib
import inspect
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
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # the resident and tridiagonal kernels' blocks per factor, swept in phase 3
BENCH_STEPS = 32          # resident kernel steps per call at the bench's shape: the bench's longest call
RESIDENT_SPMV_APPLIES = 200  # applies per multi-apply call in phase 3: the bench's m1
SHARDS = 4                # mode shards of phase 9, all on cuda:0
KRON_RANK = 63            # columns of one kron_apply_cp of a tmax=63 solution (phase 3's SpMV shape)
SHARDED_TRACE_RTOL, SHARDED_TRACE_ATOL = 1e-8, 1e-12  # sharded vs unsharded solve (tests/test_sharding.py:42-46)
SLICE_DENSE_TRACE_RTOL = 1e-7      # default (tridiagonal eigh) vs dense run: traces (tests/test_solver.py:248-261)
SLICE_DENSE_SPECTRUM_RTOL = 1e-12  # and their λ_min, λ_max traces
TRIDIAG_SLICE_K = 201              # the slice's K (kmax 200 + 1)
TRIDIAG_SLICE_KS = (1, 29, 200, 201)
TRIDIAG_FLAGSHIP = dict(K=513, k=384, kappa=1e6)  # the flagship's kmax 512 and its deciding checkpoint
HBM_BYTES_PER_S = 3.35e12                                     # H100 SXM device memory
PEAK_FLOP_S = {torch.float32: 67e12, torch.float64: 34e12}    # outside the tensor cores


class Failed(Exception):
    pass


# tridiag_eigh and expsum_sup launches of the main-path runs that the phases read, summed for the kernels line
MAIN_TALLY = {"tridiag_eigh": 0, "expsum_sup": 0}


def tally(counts):
    """Adds a run's tridiag_eigh and expsum_sup launches to MAIN_TALLY; returns counts."""
    for kernel in MAIN_TALLY:
        MAIN_TALLY[kernel] += counts.get(kernel, 0)
    return counts


def eigh_launches(dev, checks):
    """The tridiag_eigh launches a solve with eigh_impl='auto' makes: one per
    check on the card, none on the CPU (where 'auto' is the dense eigh)."""
    return {"tridiag_eigh": checks} if dev.type == "cuda" and checks else {}


def hess_launches(dev, checks):
    """The hess_eig launches of a nonsymmetric Arnoldi solve: one per check
    on the card, none on the CPU (where torch.linalg.eig runs)."""
    return {"hess_eig": checks} if dev.type == "cuda" and checks else {}


def sup_launches(dev, calls=1):
    """The exp-sum sup error's launches (ops/expsum.py): one per coefficient
    selection of a deflated or recorded solve on the card, none on the CPU
    (where the host longdouble function runs)."""
    return {"expsum_sup": calls} if dev.type == "cuda" else {}


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


def phase_tables(tkt, dev=torch.device("cuda")):
    """The exp-sum tables' file that every solve reads: the port's own copy,
    and the host ms of load_tables onto dev (each solve's setup calls it)."""
    from tensorkrylov_tpu_torch.coeffs.tables import load_tables

    path = os.path.realpath(inspect.signature(load_tables).parameters["path"].default)
    pkg = os.path.realpath(os.path.dirname(tkt.__file__))
    require(os.path.commonpath([path, pkg]) == pkg, f"the tables {path} lie outside the port's package {pkg}")
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    torch.zeros(1, device=dev)  # the context exists before the clock starts
    load_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        tables = load_tables(device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        load_ms.append(1e3 * (time.perf_counter() - t0))
    require(tables.omega.shape[1:] == (63, 63) and bool(torch.isfinite(tables.R_values).all()),
            f"the tables' arrays: omega {tuple(tables.omega.shape)}")
    emit("tables", path=os.path.relpath(path, REPO), sha256=digest, bytes=os.path.getsize(path),
         load_tables_ms=load_ms, device=str(dev))


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
    tridiag = phase_kernels_tridiag(tkt, checks, worst, times, extra)
    emit("kernels", ok=True, checks=checks,
         ms_at_d10_n131072={k: {"kernel": t[0], "plain": t[1], "dtype": "float32" if k == "resident_lanczos"
                                else "float64"} for k, t in times.items() if k not in ("resident_spmv", "tridiag_eigh")},
         fused_d10_n131072_f64=fused, resident_steps_per_call=STEPS, resident_cluster_d10_n131072=resident_g,
         ms_at_bench_shape=bench_shape, resident_spmv=resident_spmv, tridiag_eigh=tridiag, bounds=extra)
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


def lanczos_H(op, b, steps, reorth=True):
    """H (d, steps+1, steps+1) after `steps` f64 Lanczos steps on op's device
    (reorthogonalized, or the plain recurrence)."""
    from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_step

    st, _ = init_state(op, b, steps, torch.float64)
    for k in range(1, steps + 1):
        st, _ = lanczos_step(op, st, b, k, reorth=reorth, proj_dtype=torch.float64)
    return st.H


def tridiag_work(H, k, stats):
    """Bytes (T's 2k−1 entries per factor read, w and Q written) and f64
    operations of one tridiag_eigh call on H, from the plain version's count
    of what this input needs (stats: bisection-equivalent halvings, not the
    multisection's extra probes, so the work is the function's and not the
    design's; inverse-iteration solves, cluster Gram–Schmidt pairs and
    members)."""
    d, K, _ = H.shape
    nbytes = 8 * (d * (2 * k - 1) + d * K + d * K * K)
    flops = (stats["halvings"] * (3 * k + 2) + stats["solves"] * d * k * (13 * k + 1)
             + stats["mgs_pairs"] * (4 * k - 1) + stats["mgs_members"] * 3 * k)
    return nbytes, flops


def padded_for_masked_eigh(H, k):
    """The padded batch that masked_eigh hands torch.linalg.eigh: the active
    block, zero coupling, H[s, 0, 0] on the padded diagonal."""
    K = H.shape[1]
    m = (torch.arange(K, device=H.device) < k).to(H.dtype)
    Wm = H * m[None, :, None] * m[None, None, :]
    Wm = 0.5 * (Wm + Wm.transpose(1, 2))
    return Wm + torch.diag_embed((1.0 - m)[None, :] * H[:, 0, 0][:, None])


def straddling_T(k, split, seed=0):
    """(1, k, k): two decoupled random tridiagonal blocks of sizes split and
    k − split, the second shifted so that its lowest eigenvalue sits 8e-9
    above the first's highest: eigenvalues split − 1 and split form a
    two-member cluster (gap within TRIDIAG_CLUSTER_RTOL·‖T‖)."""
    rng = np.random.default_rng(seed)

    def block(m):
        a, b = rng.standard_normal(m), rng.standard_normal(m - 1)
        return np.diag(a) + np.diag(b, 1) + np.diag(b, -1)

    A, B = block(split), block(k - split)
    B += (np.linalg.eigvalsh(A)[-1] - np.linalg.eigvalsh(B)[0] + 8e-9) * np.eye(k - split)
    T = np.zeros((1, k, k))
    T[0, :split, :split], T[0, split:, split:] = A, B
    return T


def tridiag_plan(H, k, lanes=None):
    """The launch plan of tridiag_eigh on H at active size k: P lanes per
    eigenvalue, most rounds, G blocks per factor, d·G blocks, and the
    eigenvalues each block takes."""
    from tensorkrylov_tpu_torch.ops.eigen import tridiag_cluster, tridiag_lanes, tridiag_rounds

    d = H.shape[0]
    P = tridiag_lanes(d, k) if lanes is None else lanes
    G = tridiag_cluster(d, k, P, H.dtype, H.device)
    return dict(P=P, rounds=tridiag_rounds(P), G=G, blocks=d * G, per_block=-(-k // G))


def phase_kernels_tridiag(tkt, checks, worst, times, extra):
    """The tridiagonal eigensolver against its plain version on the card
    (limit 0.0 on w and Q before Newton–Schulz) on the slice's own Lanczos T
    at K=201, k = 1, 29, 200, 201, the flagship operator's T at K=513, k=384,
    W21+, a ghost-laden plain-Lanczos T, the slice's first factor alone
    (d=1: identical factors) and a two-member cluster split between two
    blocks of the factor's cluster; each case's plan (P, rounds, G, blocks)
    and work (halvings, probes); timed at the slice's last check, at the
    flagship's shape and at d=1 beside torch.linalg.eigh of the same padded
    batch (the dense path's one call), and at each (P, G)."""
    from tensorkrylov_tpu_torch.ops.eigen import (_tridiag_eigh_cuda, masked_eigh, masked_eigh_tridiag_mixed,
                                                  masked_eigh_tridiag_reference, tridiag_eigh)

    dev = torch.device("cuda")
    op, b = slice_problem(tkt, 131072, dev)
    H_slice = lanczos_H(op, b, TRIDIAG_SLICE_K - 1)
    del op, b
    q = TRIDIAG_FLAGSHIP
    op = tkt.reaction_diffusion(10, 131072, sigma_for_kappa(131072, q["kappa"]), device=dev)
    b = unit_rows(np.random.default_rng(1234), (10, 131072), torch.float64, dev)
    H_flag = lanczos_H(op, b, q["K"] - 1)
    del op, b
    w21 = np.diag(np.abs(10.0 - np.arange(21.0))) + np.diag(np.ones(20), 1) + np.diag(np.ones(20), -1)
    lam = np.concatenate([np.linspace(1.0, 2.0, 197), [4.0, 6.0, 10.0]])
    ghost_op = tkt.KroneckerSumOperator(torch.tensor(lam[None, None, :], device=dev), (0,))
    H_ghost = lanczos_H(ghost_op, unit_rows(np.random.default_rng(3), (1, 200), torch.float64, dev), 60,
                        reorth=False)
    cases = {f"slice_K201_k{k}": (H_slice, k) for k in TRIDIAG_SLICE_KS}
    cases.update({"flagship_K513_k384": (H_flag, q["k"]), "wilkinson21": (torch.tensor(w21[None], device=dev), 21),
                  "ghost_lanczos_K61_k60": (H_ghost, 60), "slice_d1_K201_k29": (H_slice[:1].contiguous(), 29)})
    # the split falls on the plan's block boundary: the first member's thread reads the second's column
    k = 29
    split = tridiag_plan(H_slice[:1], k)["per_block"]
    H_straddle = torch.zeros((1, TRIDIAG_SLICE_K, TRIDIAG_SLICE_K), dtype=torch.float64, device=dev)
    H_straddle[:, :k, :k] = torch.tensor(straddling_T(k, split if split < k else k // 2), device=dev)
    cases["straddle_d1_K201_k29"] = (H_straddle, k)
    worst["tridiag_eigh"] = 0.0
    work = {}
    for case, (H, k) in cases.items():
        got = tridiag_eigh(H, k)
        stats = {}
        ref = masked_eigh_tridiag_reference(H, k, stats=stats)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        w, Q = masked_eigh_tridiag_mixed(H, k)
        orth = float((Q.transpose(1, 2) @ Q - torch.eye(H.shape[1], dtype=H.dtype, device=dev)).abs().max())
        plan = tridiag_plan(H, k)
        checks.append(dict(kernel="tridiag_eigh", case=case, dtype="float64", d=H.shape[0], K=H.shape[1], k=k,
                           max_abs_err=err, limit=0.0, orthonormality_after_newton_schulz=orth,
                           clusters=stats["mgs_members"], halvings=stats["halvings"], probes=stats["probes"], **plan))
        require(err == 0.0, f"tridiag_eigh {case}: error {err}")
        require(orth <= 1e-13, f"tridiag_eigh {case}: Q is {orth} from orthonormal")
        worst["tridiag_eigh"] = max(worst["tridiag_eigh"], err)
        work[case] = (H, k, stats, plan)
    require(work["straddle_d1_K201_k29"][2]["mgs_members"] > 0, "tridiag_eigh straddle: no cluster formed")

    def timed(case, plain_reps):
        H, k, stats, plan = work[case]
        Wm = padded_for_masked_eigh(H, k)
        kernel_ms, plain_ms = time_pair(lambda: masked_eigh_tridiag_reference(H, k), lambda: tridiag_eigh(H, k),
                                        reps=plain_reps, warm=1)
        nbytes, flops = tridiag_work(H, k, stats)
        return dict(case=case, d=H.shape[0], K=H.shape[1], k=k, plan=plan, kernel_ms=kernel_ms, plain_ms=plain_ms,
                    kernel_ms_200=time_one(lambda: tridiag_eigh(H, k), reps=200, warm=5),
                    with_newton_schulz_ms=time_one(lambda: masked_eigh_tridiag_mixed(H, k), reps=50, warm=5),
                    library_ms=time_one(lambda: torch.linalg.eigh(Wm), reps=20, warm=3),
                    dense_masked_eigh_ms=time_one(lambda: masked_eigh(H, k), reps=20, warm=3),
                    halvings=stats["halvings"], probes=stats["probes"],
                    ms_by_P_G={P: {G: time_one(lambda: _tridiag_eigh_cuda(H, k, True, lanes=P, cluster=G),
                                               reps=20, warm=2) for G in CLUSTER_SIZES} for P in (2, 4, 8, 16, 32)},
                    **bound(nbytes, flops, torch.float64))

    at_slice = timed("slice_K201_k29", 3)
    at_flagship = timed("flagship_K513_k384", 1)
    at_d1 = timed("slice_d1_K201_k29", 3)
    times["tridiag_eigh"] = (at_slice["kernel_ms_200"], at_slice["plain_ms"])
    extra["tridiag_eigh"] = dict(bound_ms=at_slice["bound_ms"], bound_by=at_slice["bound_by"],
                                 library_ms=at_slice["library_ms"])
    return dict(at_slice_last_check=at_slice, at_flagship=at_flagship, at_d1=at_d1)


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
    return res, wall, tally(dict(_build.launches))


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
    for name, fields in dict(CONFIGS, dense=dict(CONFIGS["default"], eigh_impl="dense")).items():
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
        # 'auto' is the tridiagonal eigensolver on the card: one launch per check (check_every=1)
        eigh = "dense" if name == "dense" else "tridiag_mixed"
        require(res.config.eigh_impl == eigh, f"slice {name}: eigh_impl {res.config.eigh_impl}")
        require(counts.get("tridiag_eigh", 0) == (0 if name == "dense" else k),
                f"slice {name}: tridiag_eigh launched {counts.get('tridiag_eigh', 0)} times in {k} checks")
        if name != "dense":
            launches[kernel] = counts[kernel]
        runs[name] = dict(status=res.status, niterations=k, final_rel_residual=final, wall_s=wall,
                          iterations_per_s=k / wall, max_memory_allocated=torch.cuda.max_memory_allocated(),
                          launches=counts, step_impl=res.config.step_impl, orth=res.config.orth,
                          eigh_impl=res.config.eigh_impl)
        traces[name] = dataclasses.replace(res, x=None)
        del res, x  # the next run's peak memory must not count this one's solution
    a, c = traces["default"], traces["dense"]
    require((a.status, a.niterations) == (c.status, c.niterations),
            f"slice: default {a.status}/{a.niterations} vs dense {c.status}/{c.niterations}")
    k = a.niterations
    vs_dense = {f: float(((getattr(a, f) - getattr(c, f)).abs() / getattr(c, f).abs())[1:k + 1].max())
                for f in ("relative_residual", "lambda_min", "lambda_max")}
    require(vs_dense["relative_residual"] <= SLICE_DENSE_TRACE_RTOL, f"slice: default vs dense traces {vs_dense}")
    require(max(vs_dense["lambda_min"], vs_dense["lambda_max"]) <= SLICE_DENSE_SPECTRUM_RTOL,
            f"slice: default vs dense spectra {vs_dense}")
    emit("slice", d=10, n=131072, sigma=sigma_for_kappa(131072, 1e2), runs=runs, default_vs_dense=vs_dense,
         trace_rtol=SLICE_DENSE_TRACE_RTOL, spectrum_rtol=SLICE_DENSE_SPECTRUM_RTOL)
    return launches, traces["default"].relative_residual.cpu()


def phase_card_vs_cpu(tkt):
    out = {}
    for name, fields in CONFIGS.items():
        res = {}
        for dev in ("cuda", "cpu"):
            op, b = slice_problem(tkt, 4096, torch.device(dev))
            res[dev], _, _ = run_solve(tkt, op, b, tkt.SolverConfig(**fields, eigh_impl="tridiag_mixed"))
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
    emit("card_vs_cpu", d=10, n=4096, eigh_impl="tridiag_mixed", trace_rtol=TRACE_RTOL, spectrum_rtol=SPECTRUM_RTOL,
         runs=out)


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
    return out, time.perf_counter() - t0, tally(dict(_build.launches)), buf.getvalue()


def same_bits(a, b):
    fields = ("relative_residual", "projected_residual", "orthogonality", "lambda_min", "lambda_max", "expsum_rank")
    return ((a.status, a.niterations) == (b.status, b.niterations)
            and all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
            and torch.equal(a.x.weights, b.x.weights) and torch.equal(a.x.factors, b.x.factors))


def phase_entry_points(tkt, slice_trace, keep=None):
    """The entry points a user calls: the bench, the CLI, the system API, the
    reproduction runner, solve_multi_rhs and solve_resumable. Returns the
    bench run's resident_spmv launches (the kernel's only caller); `keep`
    takes solve_multi_rhs's lanes for phase 14."""
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
    if keep is not None:
        keep["multi_rhs"] = multi_rhs_lanes(res, wall)
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
        counts = tally(dict(_build.launches))
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


def phase_deflated(tkt, dev=torch.device("cuda"), p=DEFLATED, keep=None):
    """Phase 11: (a) the κ = 1e6 flagship through solve_deflated, storage
    'full', certified below tol with one banded_spmv launch per step and one
    for the device cross-check; (b) at the mid shape, 'full' and 'twopass'
    with plain Lanczos equal bit for bit in T and the bounds, 'segmented', and
    a twopass stopped and resumed from its state cache equal to the
    uninterrupted one; (c) the d=3, n=30 case on the card and the CPU. Each
    solve runs with the launch counts set to 0 just before it and read just
    after. Returns the phase's banded_spmv launches; `keep` (a dict) receives
    the flagship's deflation basis and summary for phase 12."""
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
    # the same solve with the dense eigh, beside the default (on the card the tridiagonal eigensolver)
    dense, dense_wall, _ = run_solve(tkt, op, b, dataclasses.replace(cfg, eigh_impl="dense"), "solve_deflated",
                                     basis=basis, checkpoints=q["checkpoints"], storage="full")
    dense_row = dict(status=dense.status, niterations=dense.niterations, certified_bound=dense.certified_bound,
                     wall_s=dense_wall)
    del dense
    res, wall, counts = run_solve(tkt, op, b, cfg, "solve_deflated", basis=basis, checkpoints=q["checkpoints"],
                                  storage="full")
    k, tol = res.niterations, cfg.tol
    x = res.x.factors
    row = dict(d=q["d"], n=q["n"], kappa=q["kappa"], sigma=sigma_for_kappa(q["n"], q["kappa"]), m=q["m"],
               config=q["config"], storage="full", setup_s=setup_s, **deflated_summary(res, wall, counts, dev),
               lambda_min=res.lambda_min, lambda_max=res.lambda_max, x_shape=list(x.shape), eigh_dense=dense_row)
    verdict = row["cross_check_verdict"]
    out["flagship"] = row
    if keep is not None:
        keep.update(flagship_basis=basis, flagship_full=row)
    emit("deflated_flagship", **row)
    require(res.status == tkt.Status.CONVERGED and res.certified_bound[-1] < tol,
            f"deflated flagship: status {res.status} after {k} steps, bounds {res.certified_bound}")
    require("CONTRADICT" not in verdict, f"deflated flagship: the cross-check contradicts the bound: {verdict}")
    require((res.status, k) == (dense_row["status"], dense_row["niterations"]),
            f"deflated flagship: {res.status}/{k} vs the dense eigh's {dense_row['status']}/{dense_row['niterations']}")
    want = {"banded_spmv": k + xc, **eigh_launches(dev, len(res.checkpoints)), **sup_launches(dev)}
    require(counts == want, f"deflated flagship: launches {counts} in {k} steps (want {want})")
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
    eigh = {**eigh_launches(dev, len(rf.checkpoints)), **sup_launches(dev)}
    require(cf == {"banded_spmv": k + xc, **eigh} and ct == {"banded_spmv": 2 * k - 1 + xc, **eigh},
            f"deflated mid: launches full {cf}, twopass {ct} in {k} steps (want {k + xc}, {2 * k - 1 + xc}, {eigh})")
    launched += cf["banded_spmv"] + ct["banded_spmv"]

    res, wall, counts = run_solve(tkt, op, b, tkt.SolverConfig(kmax=q["kmax"], tol=q["tol"]), "solve_deflated",
                                  basis=basis, storage="segmented", segment=q["segment"])
    mid["segmented"] = dict(segment=q["segment"], **deflated_summary(res, wall, counts, dev))
    require(res.boundary_drift_max is not None and math.isfinite(res.certified_bound[-1])
            and counts == {"banded_spmv": res.niterations + xc, **eigh_launches(dev, len(res.checkpoints)),
                           **sup_launches(dev)},
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
    want = {"banded_spmv": want, **eigh_launches(dev, len(res.checkpoints)), **sup_launches(dev)}
    require(counts == want, f"deflated mid resumed: launches {counts}, want {want}")
    launched += counts["banded_spmv"]
    out["mid"] = mid
    del runs, rf, rt, res, op, b, basis, U, b_perp

    # (c) card against CPU
    q = p["small"]
    got = {}
    for d_ in (dev, torch.device("cpu")):
        op = tkt.laplace(3, q["n"], shift=q["shift"], device=d_)
        b = tkt.random_rhs(3, q["n"], seed=q["seed"]).to(d_)
        got[d_.type] = run_solve(tkt, op, b, tkt.SolverConfig(**q["config"], eigh_impl="tridiag_mixed"),
                                 "solve_deflated", m=q["m"], checkpoints=q["checkpoints"])
        if d_.type == dev.type:
            launched += got[d_.type][2].get("banded_spmv", 0)
            oracle = tkt.kron_residual_dense(op, got[d_.type][0].x, b)
    g, c = got[dev.type][0], got["cpu"][0]
    bound_err = max(abs(a - r) / r for a, r in zip(g.certified_bound, c.certified_bound))
    out["card_vs_cpu"] = dict(n=q["n"], m=q["m"], eigh_impl="tridiag_mixed", status=g.status, niterations=g.niterations,
                              certified_bound=g.certified_bound, bound_max_rel_err=bound_err,
                              bound_rtol=DEFLATED_BOUND_RTOL, dense_oracle_residual=oracle)
    require((g.status, g.niterations, g.checkpoints) == (c.status, c.niterations, c.checkpoints),
            f"deflated card vs cpu: {g.status}/{g.niterations} vs {c.status}/{c.niterations}")
    require(bound_err <= DEFLATED_BOUND_RTOL, f"deflated card vs cpu: bounds differ by {bound_err}")
    require(oracle <= g.certified_bound[-1] + 1e-14, f"deflated: dense oracle {oracle} above the bound")
    emit("deflated", **out, seconds=time.perf_counter() - t_phase)
    return launched


# phase 12: the recorded-relation certificates. The flagship and the mid shape with the TPU's df64 recipes
# (tensorkrylov_tpu/experiments/data/northstar_d10_n131072_tpu.json, northstar_mid_d10_n16384_tpu.json), config 4
# through solve_block_recorded with config4_block_d10_n10240_r4_m512.json's recipe, all uncut
RECORDED = dict(
    tpu_flagship_bound=6.357734000832074e-09, tpu_mid_bound=5.304078158081677e-09, tpu_config4_bound=5.276976435725474e-09,
    flagship=DEFLATED["flagship"],
    config4=dict(n=SOLVERS["block_n"], m=512, config=dict(kmax=360, tol=1e-8)),
    mid=dict(DEFLATED["mid"], checkpoints=[64, 128, 256, 384], stop=64),
    small_df64=dict(n=64, shift=30.0, seed=5, m=6, checkpoints=[8, 16, 24], config=dict(kmax=24, tol=1e-12)),
    small_block=dict(n=48, shift=2000.0, seed=1, rank=2, config=dict(kmax=23, tol=1e-8)),
    profile_steps=8,
)
# card vs CPU certified bounds: sup + boundary to 1e-9 relative; the relation terms (dev, η, r2 ∝ ρ²) are
# roundoff records, which cuBLAS and the CPU's GEMMs round apart, so the bounds agree up to them
RECORDED_BOUND_RTOL = 1e-9
# the df64 solve's stages, deflate.py's functions timed by stage_times
DF64_STAGES = ("pair_value", "_split_rounding", "_df64_init", "_deflation_residual", "_df64_advance",
               "_evaluate_host_recorded", "_df64_gram_deviation_host", "_assemble", "cp_residual_cross_check_device")


def bound_parts(res):
    """The certified bound's components: sup, boundary (the rest), dev, η, r2."""
    rel = res.relation_dev_term + res.relation_eta_term + res.relation_r2_term
    return dict(sup=res.expsum_sup, boundary=res.certified_bound[-1] - res.expsum_sup - rel,
                dev=res.relation_dev_term, eta=res.relation_eta_term, r2=res.relation_r2_term,
                rho=res.perturbation_rho, gram_dev=res.gram_deviation, eps=res.eft_eps_measured)


@contextlib.contextmanager
def stage_times(module, names, dev):
    """Wall seconds spent in each of module's functions `names` while the
    block runs (each call synchronized at its end), into the yielded dict."""
    spent = {name: 0.0 for name in names}
    originals = {name: getattr(module, name) for name in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return call

    for name, fn in originals.items():
        setattr(module, name, timed(name, fn))
    try:
        yield spent
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def expansion_step_profile(op, b, basis, steps, dev):
    """The df64 step alone at the solve's shape: device operations per step
    and their device ms (torch.profiler over `steps` steps after two warm-up
    steps), and the synchronized wall ms per step."""
    from tensorkrylov_tpu_torch import df64_core
    from tensorkrylov_tpu_torch.ops import expansion as ex
    from tensorkrylov_tpu_torch.ops.orth import deflation_project

    U = torch.tensor(basis.U, device=dev, dtype=torch.float64)
    b_perp = deflation_project(b.to(torch.float64), U)
    st, _, _ = df64_core._df64_init(b_perp.cpu().numpy(), 2 * steps + 3, basis.m, dev)
    Upair = df64_core.pair_value(U)
    del U
    bh, bl = ex.pair_from_f64(op.bands.to(torch.float64))
    df64_core._df64_advance(bh, bl, op.offsets, st, b_perp, Upair, 1, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df64_core._df64_advance(bh, bl, op.offsets, st, b_perp, Upair, 3, steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        df64_core._df64_advance(bh, bl, op.offsets, st, b_perp, Upair, 3 + steps, steps)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / steps
    return dict(steps=steps, wall_at_k=[3, 2 + steps], profiled_at_k=[3 + steps, 2 + 2 * steps],
                wall_ms_per_step=wall, device_ops_per_step=len(ops) / steps if ops else None,
                device_ms_per_step=dev_ms if ops else None)


def phase_recorded(tkt, dev=torch.device("cuda"), p=RECORDED, keep=None):
    """Phase 12: (a) the κ = 1e6 flagship through storage='df64',
    final='device' (the TPU's recipe; phase 11's deflation basis when `keep`
    holds it), certified below tol on the measured full Gram, the
    cross-check not contradicting it, and one banded_spmv launch (the
    cross-check's A·X); its bound's components beside phase 11's 'full'
    bound and the TPU's, and the expansion step's device operations and ms;
    (b) config 4 through solve_block_recorded (m=512, kmax=360), certified
    below tol, one banded_spmv launch; (c) at the mid shape a df64 solve
    stopped at checkpoint 64 and resumed from its state cache, equal bit for
    bit to the uninterrupted one; (d) eft_selfcheck on the card, defects of
    exactly 0; (e) both solvers at small sizes on the card and the CPU. Each
    solve runs with the launch counts set to 0 just before it and read just
    after. Returns the phase's banded_spmv launches."""
    from tensorkrylov_tpu_torch import deflate
    from tensorkrylov_tpu_torch.experiments.northstar import interpret_cross_check
    from tensorkrylov_tpu_torch.ops import expansion as ex

    t_phase = time.perf_counter()
    out, launched = {}, 0
    keep = keep or {}
    # the device cross-check's A·X (final='device' runs it on either device) and, on the card, the sup error's
    one = {"banded_spmv": 1, **sup_launches(dev)}

    # (d) the transforms on the card
    chk = ex.eft_selfcheck(device=dev)
    out["eft_selfcheck"] = chk
    require(chk["two_sum"] == 0.0 and chk["two_prod"] == 0.0, f"eft_selfcheck on {dev}: {chk}")

    # (a) the flagship, storage='df64', final='device'
    q = p["flagship"]
    op, b = deflated_problem(tkt, q, dev)
    basis = keep.get("flagship_basis")
    setup_s = 0.0
    if basis is None:
        t0 = time.perf_counter()
        basis = tkt.deflation_basis(op, q["m"])
        setup_s = time.perf_counter() - t0
    cfg = tkt.SolverConfig(**q["config"])
    with stage_times(deflate, DF64_STAGES, dev) as stages:
        res, wall, counts = run_solve(tkt, op, b, cfg, "solve_deflated", basis=basis, checkpoints=q["checkpoints"],
                                      storage="df64", final="device")
    k, tol = res.niterations, cfg.tol
    x = res.x.factors
    full = keep.get("flagship_full", {})
    row = dict(d=q["d"], n=q["n"], kappa=q["kappa"], m=q["m"], config=q["config"], storage="df64", final="device",
               setup_s=setup_s, basis_from_phase_11="flagship_basis" in keep,
               **deflated_summary(res, wall, counts, dev), stages_s=stages, components=bound_parts(res),
               gram_source=res.gram_source,
               full_storage_bound=(full.get("certified_bound") or [None])[-1], tpu_df64_bound=p["tpu_flagship_bound"])
    verdict = row["cross_check_verdict"]
    require(res.status == tkt.Status.CONVERGED and res.certified_bound[-1] < tol,
            f"recorded flagship: status {res.status} after {k} steps, bounds {res.certified_bound}")
    require(res.gram_source == "measured full Gram", f"recorded flagship: gram source {res.gram_source}")
    require("CONTRADICT" not in verdict, f"recorded flagship: the cross-check contradicts the bound: {verdict}")
    require(counts == one, f"recorded flagship: launches {counts} (want {one}: the cross-check's)")
    require(x.shape[:2] == (q["d"], q["n"]) and bool(torch.isfinite(x).all()) and x.device.type == dev.type,
            f"recorded flagship: bad solution (shape {tuple(x.shape)}, device {x.device})")
    launched += counts.get("banded_spmv", 0)
    del res, x
    if dev.type == "cuda":
        row["expansion_step"] = expansion_step_profile(op, b, basis, p["profile_steps"], dev)
    out["flagship"] = row
    emit("recorded_flagship", **row)
    keep["flagship_df64"] = row
    del op, b, basis

    # (b) config 4 through solve_block_recorded, at the recipe's m and kmax
    q = p["config4"]
    op4, B = config4_problem(tkt, q["n"], dev)
    n4, d4 = op4.n, op4.d
    sigma = sigma_for_kappa(n4, SOLVERS["block_kappa"])
    lam_min = d4 * (sigma + 4.0 * (n4 + 1) ** 2 * np.sin(np.pi / (2 * (n4 + 1))) ** 2)
    t0 = time.perf_counter()
    basis = tkt.deflation_basis(op4, q["m"])
    setup_s = time.perf_counter() - t0
    res, wall, counts = run_solve(tkt, op4, B, tkt.SolverConfig(**q["config"]), "solve_block_recorded",
                                  lam_min=lam_min, basis=basis, final="device")
    verdict = interpret_cross_check(res.measured_cp_residual, res.cp_residual_floor, res.certified_bound[-1],
                                    q["config"]["tol"])
    out["config4"] = dict(d=d4, n=n4, kappa=SOLVERS["block_kappa"], rank=B.shape[0], m=q["m"], config=q["config"],
                          status=res.status, niterations=res.niterations, checkpoints=res.checkpoints,
                          certified_bound=res.certified_bound, estimate=res.relative_residual,
                          components=bound_parts(res), sweep_overlap=res.sweep_overlap,
                          measured_cp_residual=res.measured_cp_residual, cp_residual_floor=res.cp_residual_floor,
                          cross_check_verdict=verdict, setup_s=setup_s, wall_s=wall,
                          max_memory_allocated=peak_bytes(dev), launches=counts,
                          tpu_recorded_bound=p["tpu_config4_bound"])
    require(res.converged and res.certified_bound[-1] < q["config"]["tol"],
            f"recorded config 4: status {res.status} after {res.niterations}, bounds {res.certified_bound}")
    require("CONTRADICT" not in verdict, f"recorded config 4: {verdict}")
    want = {"banded_spmv": 1, **sup_launches(dev, len(res.checkpoints))}     # the sup error at every checkpoint
    require(counts == want, f"recorded config 4: launches {counts} (want {want})")
    launched += counts.get("banded_spmv", 0)
    del res, op4, B, basis

    # (c) the mid shape: stopped at checkpoint 64, resumed from its state cache, against the uninterrupted solve
    q = p["mid"]
    op, b = deflated_problem(tkt, q, dev)
    basis = tkt.deflation_basis(op, q["m"])
    cfg = tkt.SolverConfig(kmax=q["kmax"], tol=q["tol"])
    kw = dict(basis=basis, storage="df64", final="device", checkpoints=q["checkpoints"])
    ref, wall, counts = run_solve(tkt, op, b, cfg, "solve_deflated", **kw)
    launched += counts.get("banded_spmv", 0)
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "state.npz")
        _, wall_stop, counts_stop = run_solve(tkt, op, b, cfg, "solve_deflated", **{
            **kw, "checkpoints": [q["stop"]]}, state_cache=cache)
        res, wall_res, counts_res = run_solve(tkt, op, b, cfg, "solve_deflated", **kw, state_cache=cache)
    launched += counts_stop.get("banded_spmv", 0) + counts_res.get("banded_spmv", 0)
    same = (res.certified_bound == ref.certified_bound and res.relative_residual == ref.relative_residual
            and torch.equal(res.x.factors, ref.x.factors) and torch.equal(res.x.weights, ref.x.weights))
    out["mid"] = dict(d=q["d"], n=q["n"], kappa=q["kappa"], m=q["m"], kmax=q["kmax"], tol=q["tol"],
                      uninterrupted=dict(deflated_summary(ref, wall, counts, dev), components=bound_parts(ref)),
                      stopped_at=q["stop"], stop_wall_s=wall_stop, resumed_wall_s=wall_res,
                      resumed_bit_equal=same, tpu_df64_bound=p["tpu_mid_bound"])
    require(ref.status == tkt.Status.CONVERGED and ref.certified_bound[-1] < q["tol"],
            f"recorded mid: status {ref.status}, bounds {ref.certified_bound}")
    require(same, f"recorded mid: the resumed solve differs from the uninterrupted one ({res.certified_bound} vs "
                  f"{ref.certified_bound})")
    require(counts == counts_stop == counts_res == one,
            f"recorded mid: launches {counts}, {counts_stop}, {counts_res}")
    del ref, res, op, b, basis

    # (e) card against CPU, both solvers
    q, qb = p["small_df64"], p["small_block"]
    got = {}
    for d_ in (dev, torch.device("cpu")):
        op = tkt.laplace(2, q["n"], shift=q["shift"], device=d_)
        b = tkt.random_rhs(2, q["n"], seed=q["seed"])
        b = (b / torch.linalg.vector_norm(b, dim=1, keepdim=True)).to(d_)
        r_df = run_solve(tkt, op, b, tkt.SolverConfig(**q["config"]), "solve_deflated", m=q["m"], storage="df64",
                         final="device", checkpoints=q["checkpoints"])
        opb = tkt.laplace(2, qb["n"], shift=qb["shift"], device=d_)
        B = np.random.default_rng(qb["seed"]).standard_normal((qb["rank"], 2, qb["n"]))
        lmin = 2 * float(np.linalg.eigvalsh(tkt.bands_to_dense(opb)[0])[0])
        r_bl = run_solve(tkt, opb, B, tkt.SolverConfig(**qb["config"]), "solve_block_recorded", lam_min=lmin,
                         final="device")
        if d_.type == dev.type:
            launched += r_df[2].get("banded_spmv", 0) + r_bl[2].get("banded_spmv", 0)
            oracle = tkt.kron_residual_dense(op, r_df[0].x, b)
        got[d_.type] = (r_df[0], r_bl[0])
    cvc = {}
    for i, name in enumerate(("df64", "block_recorded")):
        g, c = got[dev.type][i], got["cpu"][i]
        slack = max(bound_parts(x)["dev"] + bound_parts(x)["eta"] + bound_parts(x)["r2"] for x in (g, c))
        err = max(max(abs(a - r) - slack, 0.0) / r for a, r in zip(g.certified_bound, c.certified_bound))
        cvc[name] = dict(status=g.status, niterations=g.niterations, checkpoints=g.checkpoints,
                         certified_bound=g.certified_bound, cpu_certified_bound=c.certified_bound,
                         relation_slack=slack, bound_max_rel_err=err)
        require((g.status, g.niterations, g.checkpoints) == (c.status, c.niterations, c.checkpoints),
                f"recorded {name} card vs cpu: {g.status}/{g.niterations} vs {c.status}/{c.niterations}")
        require(err <= RECORDED_BOUND_RTOL, f"recorded {name} card vs cpu: bounds differ by {err}")
    require(oracle <= got[dev.type][0].certified_bound[-1], f"recorded df64: dense oracle {oracle} above the bound")
    out["card_vs_cpu"] = dict(cvc, bound_rtol=RECORDED_BOUND_RTOL, df64_dense_oracle_residual=oracle)
    emit("recorded", **{k_: v for k_, v in out.items() if k_ != "flagship"}, seconds=time.perf_counter() - t_phase)
    return launched


# phase 13: the mode-sharded deflated solve on SHARDS shards of cuda:0 (phase 11's basis), the TPU's two
# production modes on the flagship (tensorkrylov_tpu/deflate.py:682-683, __graft_entry__.py:79-108), the mid
# shape on 'full', example 03 and the nonsymmetric runner at the TPU artifact's recipe
# (tensorkrylov_tpu/experiments/data/nonsym_scale_d10_n16384.json), all uncut
SHARDED_DEFLATED = dict(
    flagship=DEFLATED["flagship"],
    mid=dict(DEFLATED["mid"], config=dict(kmax=384, tol=1e-8)),
    example_argv=[],
    nonsym_argv=[],
    tpu_nonsym=dict(niterations=320, relative_residual=1.011799785729646e-08,
                    measured_cp_residual=1.0563509031222946e-07, solve_s=131.78391633200226),
)
SHARDED_DF64_RTOL = 1e-6    # the df64 flagship's bound over 4 shards against phase 12's unsharded one
# the mid shape's bounds over 4 shards against the unsharded ones (reorthogonalized): 1e-9 relative beside
# 1e-15 absolute, the boundary row being small against y and rounding to eps·‖y‖ (tests/test_torch_deflate.py)
SHARDED_MID_RTOL, SHARDED_MID_ATOL = 1e-9, 1e-15


def phase_sharded_deflated(tkt, dev=torch.device("cuda", 0), p=SHARDED_DEFLATED, keep=None):
    """Phase 13: solve_deflated(mesh=) on SHARDS mode shards of one device:
    (a) the flagship on storage='twopass', comm='ring' (the JAX package's
    sharded production mode), certified below tol with one ring launch per
    SpMV of both passes and one banded_spmv launch (the cross-check's A·X),
    its bound beside phase 11's 'full' one; (b) the flagship on
    storage='df64', comm='gspmd', final='device' (the certifying mode),
    certified below tol within SHARDED_DF64_RTOL of phase 12's bound, one
    launch (the cross-check's; the pair SpMV is torch ops), its components and
    stage times beside phase 12's; (c) the mid shape on 'full' with gspmd
    (SHARDS banded_spmv launches per step) against the unsharded solve, the
    bounds within SHARDED_MID_RTOL beside SHARDED_MID_ATOL; (d) examples/03_sharded_torch.py and the
    nonsymmetric runner at the TPU artifact's recipe, unsharded, beside the
    TPU's numbers. Each path runs with the launch counts set to 0 just before
    it and read just after; the counts are checked on the card. Returns the
    phase's (banded_spmv, ring_spmv) launches. `keep` holds phase 11's basis
    and both phases' flagship rows where they ran."""
    import runpy

    from tensorkrylov_tpu_torch import deflate
    from tensorkrylov_tpu_torch.experiments import nonsym_scale
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    keep = keep if keep is not None else {}
    on_card = dev.type == "cuda"
    out, launched = {}, {"banded_spmv": 0, "ring_spmv": 0}

    def count(counts):
        for name in launched:
            launched[name] += counts.get(name, 0)

    def expect(counts, want, what):
        if on_card:
            require(counts == want, f"sharded_deflated {what}: launches {counts}, want {want}")

    mesh = make_mesh(devices=[dev] * SHARDS)
    q = p["flagship"]
    op, b = deflated_problem(tkt, q, dev)
    basis = keep.pop("flagship_basis", None)
    setup_s = 0.0
    if basis is None:
        t0 = time.perf_counter()
        basis = tkt.deflation_basis(op, q["m"])
        setup_s = time.perf_counter() - t0
    cfg = tkt.SolverConfig(**q["config"])
    tol = cfg.tol
    common = dict(d=q["d"], n=q["n"], kappa=q["kappa"], m=q["m"], config=q["config"], shards=SHARDS,
                  devices=[str(dev)] * SHARDS, setup_s=setup_s, basis_from_phase_11=setup_s == 0.0)

    # (a) the flagship, storage='twopass', comm='ring'
    res, wall, counts = run_solve(tkt, op, b, cfg, "solve_deflated", basis=basis, checkpoints=q["checkpoints"],
                                  storage="twopass", mesh=mesh, comm="ring")
    k, x = res.niterations, res.x.factors
    full = (keep.get("flagship_full", {}).get("certified_bound") or [None])[-1]
    row = dict(common, storage="twopass", comm="ring", **deflated_summary(res, wall, counts, dev),
               phase_11_full_bound=full,
               bound_rel_diff_vs_phase_11=None if full is None else abs(res.certified_bound[-1] - full) / full)
    out["twopass_ring"] = row
    require(res.status == tkt.Status.CONVERGED and res.certified_bound[-1] < tol,
            f"sharded twopass flagship: status {res.status} after {k} steps, bounds {res.certified_bound}")
    require("CONTRADICT" not in row["cross_check_verdict"],
            f"sharded twopass flagship: the cross-check contradicts the bound: {row['cross_check_verdict']}")
    expect(counts, {"ring_spmv": 2 * k - 1, "banded_spmv": 1, **eigh_launches(dev, len(res.checkpoints)),
                    **sup_launches(dev)},
           "twopass flagship")
    require(tuple(x.shape[:2]) == (q["d"], q["n"]) and bool(torch.isfinite(x).all()) and x.device == dev,
            f"sharded twopass flagship: bad solution (shape {tuple(x.shape)}, device {x.device})")
    count(counts)
    del res, x

    # (b) the flagship, storage='df64', comm='gspmd', final='device'
    with stage_times(deflate, DF64_STAGES, dev) as stages:
        res, wall, counts = run_solve(tkt, op, b, cfg, "solve_deflated", basis=basis, checkpoints=q["checkpoints"],
                                      storage="df64", final="device", mesh=mesh, comm="gspmd")
    k, x = res.niterations, res.x.factors
    df = keep.get("flagship_df64", {})
    ref = (df.get("certified_bound") or [None])[-1]
    diff = None if ref is None else abs(res.certified_bound[-1] - ref) / ref
    row = dict(common, storage="df64", comm="gspmd", final="device", **deflated_summary(res, wall, counts, dev),
               stages_s=stages, components=bound_parts(res), gram_source=res.gram_source,
               phase_12_bound=ref, bound_rel_diff_vs_phase_12=diff, bound_rtol=SHARDED_DF64_RTOL,
               phase_12_components=df.get("components"), phase_12_stages_s=df.get("stages_s"),
               phase_12_wall_s=df.get("wall_s"))
    out["df64_gspmd"] = row
    require(res.status == tkt.Status.CONVERGED and res.certified_bound[-1] < tol,
            f"sharded df64 flagship: status {res.status} after {k} steps, bounds {res.certified_bound}")
    require(res.gram_source == "measured full Gram", f"sharded df64 flagship: gram source {res.gram_source}")
    require("CONTRADICT" not in row["cross_check_verdict"],
            f"sharded df64 flagship: the cross-check contradicts the bound: {row['cross_check_verdict']}")
    require(diff is None or diff <= SHARDED_DF64_RTOL,
            f"sharded df64 flagship: bound {res.certified_bound[-1]} vs phase 12's {ref} (relative {diff})")
    expect(counts, {"banded_spmv": 1, **sup_launches(dev)}, "df64 flagship")
    require(tuple(x.shape[:2]) == (q["d"], q["n"]) and bool(torch.isfinite(x).all()) and x.device == dev,
            f"sharded df64 flagship: bad solution (shape {tuple(x.shape)}, device {x.device})")
    count(counts)
    emit("sharded_deflated_flagship", **out)
    del res, x, op, b, basis

    # (c) the mid shape on 'full', gspmd, against the unsharded solve (reorthogonalized)
    q = p["mid"]
    op, b = deflated_problem(tkt, q, dev)
    basis = tkt.deflation_basis(op, q["m"])
    cfg = tkt.SolverConfig(**q["config"])
    ref, wall_ref, counts_ref = run_solve(tkt, op, b, cfg, "solve_deflated", basis=basis, storage="full")
    res, wall, counts = run_solve(tkt, op, b, cfg, "solve_deflated", basis=basis, storage="full", mesh=mesh,
                                  comm="gspmd")
    k = res.niterations
    diff = max(abs(a - r) / r for a, r in zip(res.certified_bound, ref.certified_bound))
    mid = dict(d=q["d"], n=q["n"], kappa=q["kappa"], m=q["m"], config=q["config"], shards=SHARDS,
               sharded=deflated_summary(res, wall, counts, dev),
               unsharded=deflated_summary(ref, wall_ref, counts_ref, dev), bound_max_rel_diff=diff,
               bound_max_abs_diff=max(abs(a - r) for a, r in zip(res.certified_bound, ref.certified_bound)),
               bound_rtol=SHARDED_MID_RTOL, bound_atol=SHARDED_MID_ATOL)
    require((res.status, k, res.checkpoints) == (ref.status, ref.niterations, ref.checkpoints),
            f"sharded mid: {res.status}/{k} at {res.checkpoints} vs unsharded {ref.status}/{ref.niterations}")
    require(all(abs(a - r) <= SHARDED_MID_RTOL * r + SHARDED_MID_ATOL
                for a, r in zip(res.certified_bound, ref.certified_bound)),
            f"sharded mid: bounds differ by {diff} relative ({res.certified_bound} vs {ref.certified_bound})")
    expect(counts, {"banded_spmv": SHARDS * k + 1, **eigh_launches(dev, len(res.checkpoints)), **sup_launches(dev)},
           "mid full gspmd")
    expect(counts_ref, {"banded_spmv": ref.niterations + 1, **eigh_launches(dev, len(ref.checkpoints)),
                        **sup_launches(dev)}, "mid unsharded")
    count(counts)
    count(counts_ref)
    del res, ref, op, b, basis

    # (d) example 03, then the nonsymmetric runner at the TPU artifact's recipe
    main03 = runpy.run_path(os.path.join(REPO, "examples", "03_sharded_torch.py"), run_name="example")["main"]
    if on_card:
        torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rs, rd = main03(list(p["example_argv"]))
    if on_card:
        torch.cuda.synchronize()
    wall, counts = time.perf_counter() - t0, tally(dict(_build.launches))
    ks, kd = rs.niterations, rd.niterations
    ex03 = dict(printed=printed.getvalue().splitlines(), wall_s=wall, launches=counts,
                solve_sharded=dict(status=rs.status, niterations=ks), solve_deflated=dict(
                    status=rd.status, niterations=kd, certified_bound=rd.certified_bound,
                    measured_cp_residual=rd.measured_cp_residual, cp_residual_floor=rd.cp_residual_floor))
    require(bool(torch.isfinite(rs.x.factors).all()) and bool(torch.isfinite(rd.x.factors).all())
            and rd.status == tkt.Status.CONVERGED, f"example 03: {ex03}")
    # solve_sharded on the 2 x 2 mesh: gspmd, one banded_spmv launch per shard and step; the deflated
    # twopass on the ring route: one launch per SpMV of both passes, and the cross-check's A·X; the
    # tridiagonal eigensolver at each check of both
    expect(counts, {"banded_spmv": SHARDS * ks + 1, "ring_spmv": 2 * kd - 1,
                    **eigh_launches(dev, len(checked(rs)) + len(rd.checkpoints)), **sup_launches(dev)}, "example 03")
    count(counts)
    with tempfile.TemporaryDirectory() as tmp:
        if on_card:
            torch.cuda.synchronize()
        _build.launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            art = nonsym_scale.main(list(p["nonsym_argv"]) + ["--out", os.path.join(tmp, "nonsym.json")])
        wall, counts = time.perf_counter() - t0, tally(dict(_build.launches))
    r = art["result"]
    nonsym = dict(art, printed=printed.getvalue().splitlines(), wall_s=wall, launches=counts, tpu=p["tpu_nonsym"])
    require(r["converged"] and math.isfinite(r["relative_residual"]) and math.isfinite(r["measured_cp_residual"]),
            f"nonsym_scale: {r}")
    # one banded_spmv launch per Arnoldi step, and the device cross-check's A·X; hess_eig at each check
    rec = art["recipe"]
    checks = sum(1 for k in range(1, r["niterations"] + 1) if k % rec["check_every"] == 0 or k >= rec["kmax"])
    expect(counts, {"banded_spmv": r["niterations"] + 1, **hess_launches(dev, checks)}, "nonsym_scale")
    count(counts)
    emit("sharded_deflated", mid=mid, example_03=ex03, nonsym_scale=nonsym, launches=launched,
         seconds=time.perf_counter() - t_phase)
    return launched["banded_spmv"], launched["ring_spmv"]


# phase 14: the JAX dry run's sharded call forms (__graft_entry__.py:112-165) on shard slots of cuda:0: config 4
# through solve_block, the slice through solve_two_pass, phase 8's rank-2 input through solve_multi_rhs on a
# ('rhs', 'factor', 'mode') mesh, and dryrun_multichip itself at its own sizes
SHARDED_SOLVERS = dict(SOLVERS, multi_rhs_mesh=dict(rhs_parallel=2, factor_parallel=1), multi_rhs_slots=4,
                       dryrun_slots=8)
# the two-pass over 4 shards against the unsharded one: steps within one (the JAX dry run's rule,
# __graft_entry__.py:75-79), x relative to max|x| and the final estimate within 1e-6 relative. The unfused
# route's b̃_k = ⟨v_k, b⟩ carries the plain recurrence's v_0 drift (its `orthogonality` trace, ~4e-12 at the
# slice), which another sum order redraws: the estimate may move by d·√k·(drift of both runs)·‖b‖ more, the
# most that a change of that size in the rank-1 b̃ moves ‖(Σ⊕H) y − b̃‖; λ_min and λ_max (from H alone) hold
# to SHARDED_TRACE_RTOL
TWO_PASS_SHARDED_RTOL, TWO_PASS_SHARDED_STEPS = 1e-6, 1


def multi_rhs_lanes(res, wall):
    """solve_multi_rhs's per-lane statuses, steps and traces, on the host."""
    return dict(status=res.status.tolist(), niterations=res.niterations.tolist(), wall_s=wall,
                **{f: getattr(res, f).cpu() for f in ("relative_residual", "lambda_min", "lambda_max")})


def within(a, r, rtol, atol):
    """Whether a is r to rtol beside atol at every step r recorded; and the largest relative difference."""
    a, r = np.asarray(a), np.asarray(r)
    ok = np.isfinite(r) & (r != 0)
    return bool(np.all(np.abs(a[ok] - r[ok]) <= atol + rtol * np.abs(r[ok]))), float(
        np.max(np.abs(a[ok] - r[ok]) / np.abs(r[ok])))


def phase_sharded_solvers(tkt, dev=torch.device("cuda", 0), p=SHARDED_SOLVERS, keep=None):
    """Phase 14: the sharded block, two-pass and multi-RHS solves on shard
    slots of one device. (a) config 4 through solve_block on SHARDS mode
    shards, comm='gspmd' (SHARDS banded_spmv launches per block step) and
    'ring' (one ring launch per block step), each against the unsharded
    solve_block: the same status and block steps, the traces within
    SHARDED_TRACE_RTOL beside SHARDED_TRACE_ATOL. (b) the slice through
    solve_two_pass on ring (one launch per SpMV of both passes) and gspmd
    (SHARDS per SpMV) against the unsharded solve_two_pass (steps within
    one, x and the estimate within TWO_PASS_SHARDED_RTOL, the estimate beside
    the v_0 drift's allowance). (c) phase 8's rank-2 solve_multi_rhs input on
    a (rhs=2, factor=1, mode=2) mesh: each lane against phase 8's unsharded
    lane (its status, steps and traces), status of shape (2,). (d)
    experiments/dryrun_multichip.run on 8 slots: every call of the JAX dry
    run with its own checks, on a (2, 4) and a (2, 2, 2) mesh. Each path
    runs with the launch counts set to 0 just before it and read just after;
    the counts are checked on the card. Returns the phase's (banded_spmv,
    ring_spmv) launches."""
    from tensorkrylov_tpu_torch.experiments import dryrun_multichip
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.parallel import make_mesh, shard_operator, shard_rhs

    t_phase = time.perf_counter()
    keep = keep if keep is not None else {}
    on_card = dev.type == "cuda"
    out, launched = {}, {"banded_spmv": 0, "ring_spmv": 0}

    def count(counts):
        for name in launched:
            launched[name] += counts.get(name, 0)

    def expect(counts, want, what):
        if on_card:
            require(counts == want, f"sharded_solvers {what}: launches {counts}, want {want}")

    def summary(res, wall, counts):
        k = res.niterations
        return dict(status=res.status, niterations=k, wall_s=wall, iterations_per_s=k / wall,
                    final_rel_residual=float(res.relative_residual[k]), max_memory_allocated=peak_bytes(dev),
                    launches=counts)

    mesh = make_mesh(devices=[dev] * SHARDS)

    # (a) config 4 through solve_block on SHARDS mode shards, both routes, against the unsharded solve
    op4, B = config4_problem(tkt, p["block_n"], dev, p)
    cfg = tkt.SolverConfig(**p["block"])
    ref, wall, counts = run_solve(tkt, op4, B, cfg, "solve_block")
    block = dict(d=op4.d, n=op4.n, kappa=p["block_kappa"], rank=p["block_rank"], config=p["block"], shards=SHARDS,
                 trace_rtol=SHARDED_TRACE_RTOL, trace_atol=SHARDED_TRACE_ATOL,
                 unsharded=summary(ref, wall, counts))
    count(counts)
    ref_status, k_ref = ref.status, ref.niterations
    ref_traces = {f: getattr(ref, f).cpu().numpy() for f in ("relative_residual", "lambda_min", "lambda_max")}
    del ref
    for comm in ("gspmd", "ring"):
        sop = shard_operator(op4, mesh, comm)
        res, wall, counts = run_solve(tkt, sop, shard_rhs(B, mesh, op4.d), cfg, "solve_block")
        k, x = res.niterations, res.x.factors
        row = summary(res, wall, counts)
        held = {f: within(getattr(res, f).cpu().numpy(), r, SHARDED_TRACE_RTOL, SHARDED_TRACE_ATOL)
                for f, r in ref_traces.items()}
        row["trace_max_rel_diff"] = {f: h[1] for f, h in held.items()}
        require((res.status, k) == (ref_status, k_ref) and res.status != tkt.Status.BREAKDOWN,
                f"sharded block {comm}: {res.status}/{k} vs unsharded {ref_status}/{k_ref}")
        require(all(h[0] for h in held.values()), f"sharded block {comm}: traces differ by {row['trace_max_rel_diff']}")
        require(tuple(x.shape) == (op4.d, op4.n, cfg.tmax * p["block_rank"]) and bool(torch.isfinite(x).all())
                and x.device == dev, f"sharded block {comm}: bad solution (shape {tuple(x.shape)}, device {x.device})")
        # all shards share the card: one ring launch per block step, or one banded_spmv launch per shard and step
        expect(counts, {"ring_spmv": k} if comm == "ring" else {"banded_spmv": SHARDS * k}, f"block {comm}")
        count(counts)
        block[comm] = row
        del res, x, sop
    out["block_config4"] = block
    del op4, B

    # (b) the slice through solve_two_pass on both routes, against the unsharded two-pass
    op, b = slice_problem(tkt, p["slice_n"], dev)
    cfg = tkt.SolverConfig(**p["two_pass"])
    ref, wall, counts = run_solve(tkt, op, b, cfg, "solve_two_pass")
    two = dict(d=op.d, n=op.n, config=p["two_pass"], shards=SHARDS, rtol=TWO_PASS_SHARDED_RTOL,
               steps_within=TWO_PASS_SHARDED_STEPS, unsharded=summary(ref, wall, counts))
    count(counts)
    kr, x_ref = ref.niterations, ref.x.factors
    est_ref, xmax = float(ref.relative_residual[kr]), float(x_ref.abs().max())
    drift_ref = float(ref.orthogonality[1:kr + 1].max())
    lam_ref = {f: getattr(ref, f).cpu().numpy()[:kr + 1] for f in ("lambda_min", "lambda_max")}
    del ref
    for comm in ("ring", "gspmd"):
        sop = shard_operator(op, mesh, comm)
        res, wall, counts = run_solve(tkt, sop, shard_rhs(b, mesh), cfg, "solve_two_pass")
        k, x = res.niterations, res.x.factors
        est = float(res.relative_residual[k])
        drift = float(res.orthogonality[1:k + 1].max())
        allowance = op.d * math.sqrt(max(k, kr)) * (drift + drift_ref)
        x_diff = float((x - x_ref).abs().max()) / xmax
        m = min(k, kr) + 1
        held = {f: within(getattr(res, f).cpu().numpy()[:m], r[:m], SHARDED_TRACE_RTOL, 0.0)
                for f, r in lam_ref.items()}
        row = dict(summary(res, wall, counts), x_max_rel_diff=x_diff, final_rel_diff=abs(est - est_ref) / est_ref,
                   final_abs_diff=abs(est - est_ref), v0_drift=drift, v0_drift_unsharded=drift_ref,
                   drift_allowance=allowance, lambda_max_rel_diff={f: h[1] for f, h in held.items()})
        require(res.status == tkt.Status.CONVERGED and abs(k - kr) <= TWO_PASS_SHARDED_STEPS,
                f"sharded two_pass {comm}: status {res.status} after {k} steps, unsharded {kr}")
        require(x_diff <= TWO_PASS_SHARDED_RTOL and bool(torch.isfinite(x).all()) and x.device == dev,
                f"sharded two_pass {comm}: x differs by {x_diff} of max|x|")
        require(abs(est - est_ref) <= TWO_PASS_SHARDED_RTOL * est_ref + allowance,
                f"sharded two_pass {comm}: final estimate {est} vs {est_ref} (drift allowance {allowance})")
        require(all(h[0] for h in held.values()), f"sharded two_pass {comm}: λ traces {row['lambda_max_rel_diff']}")
        expect(counts, {**({"ring_spmv": 2 * k} if comm == "ring" else {"banded_spmv": SHARDS * 2 * k}),
                        **eigh_launches(dev, k)}, f"two_pass {comm}")
        count(counts)
        two[comm] = row
        del res, x, sop
    out["two_pass"] = two
    del x_ref

    # (c) phase 8's rank-2 input through solve_multi_rhs on a (rhs=2, factor=1, mode=2) mesh
    b2 = tkt.random_rhs(op.d, op.n, seed=1235)
    B = torch.stack([b, (b2 / torch.linalg.vector_norm(b2, dim=1, keepdim=True)).to(dev)])
    cfg = tkt.SolverConfig(**CONFIGS["default"])
    lanes = keep.get("multi_rhs")
    if lanes is None:   # phase 8 did not run
        mr, wall, counts = run_solve(tkt, op, B, cfg, "solve_multi_rhs")
        lanes = multi_rhs_lanes(mr.results, wall)
        count(counts)
        del mr
    mesh3 = make_mesh(devices=[dev] * p["multi_rhs_slots"], **p["multi_rhs_mesh"])
    mr, wall, counts = run_solve(tkt, op, B, cfg, "solve_multi_rhs", mesh=mesh3)
    res = mr.results
    ks = res.niterations.tolist()
    held = {f: within(getattr(res, f).cpu().numpy(), lanes[f].numpy(), SHARDED_TRACE_RTOL, SHARDED_TRACE_ATOL)
            for f in ("relative_residual", "lambda_min", "lambda_max")}
    multi = dict(mesh=mesh3.shape, slots=[str(dev)] * p["multi_rhs_slots"], statuses=res.status.tolist(),
                 niterations=ks, wall_s=wall, iterations_per_s=sum(ks) / wall, max_memory_allocated=peak_bytes(dev),
                 launches=counts, unsharded=dict(statuses=lanes["status"], niterations=lanes["niterations"],
                                                 wall_s=lanes["wall_s"]),
                 trace_max_rel_diff={f: h[1] for f, h in held.items()}, trace_rtol=SHARDED_TRACE_RTOL,
                 trace_atol=SHARDED_TRACE_ATOL)
    require(tuple(res.status.shape) == (2,) and res.status.tolist() == lanes["status"]
            and ks == lanes["niterations"] and mr.converged,
            f"multi_rhs on {mesh3.shape}: {res.status.tolist()}/{ks} vs unsharded {lanes['status']}/"
            f"{lanes['niterations']}")
    require(all(h[0] for h in held.values()), f"multi_rhs on {mesh3.shape}: traces {multi['trace_max_rel_diff']}")
    require(tuple(mr.x.factors.shape) == (op.d, op.n, 2 * cfg.tmax) and bool(torch.isfinite(mr.x.factors).all()),
            f"multi_rhs on {mesh3.shape}: bad solution (shape {tuple(mr.x.factors.shape)})")
    # each lane over its group's 2 mode shards on the gspmd route: 2 banded_spmv launches per step, and
    # one tridiag_eigh launch per check
    expect(counts, {"banded_spmv": mesh3.shape["mode"] * sum(ks), **eigh_launches(dev, sum(ks))}, "multi_rhs")
    count(counts)
    out["multi_rhs"] = multi
    del mr, res, op, b, B

    # (d) the JAX dry run's every call, at its own sizes, on 8 slots
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    t0 = time.perf_counter()
    try:
        dry = dryrun_multichip.run([dev] * p["dryrun_slots"])
    except AssertionError as e:
        raise Failed(str(e)) from e
    if on_card:
        torch.cuda.synchronize()
    wall, counts = time.perf_counter() - t0, tally(dict(_build.launches))
    if on_card:
        require(counts.get("banded_spmv", 0) > 0 and counts.get("ring_spmv", 0) > 0,
                f"dryrun_multichip: launches {counts}")
    count(counts)
    out["dryrun_multichip"] = dict(dry, slots=p["dryrun_slots"], wall_s=wall, max_memory_allocated=peak_bytes(dev),
                                   launches=counts)
    emit("sharded_solvers", **out, launches=launched, seconds=time.perf_counter() - t_phase)
    return launched["banded_spmv"], launched["ring_spmv"]


# phase 15: the multi-process layer. Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one card), each
# owning 2 shard slots, through init_distributed, make_pod_mesh and distribute_problem: the slice in phase 9's
# three layouts ('factor' across the processes; 'mode' across them on the ring and the gspmd route) and the
# mid shape's deflated twopass on the ring route, each bit for bit against one controller on the same layout
MULTIHOST = dict(
    device="cuda:0", cards=1, n=131072, slots=2, worker_timeout=600, smoke_timeout=180, threads=2, probe_reps=200,
    layouts={"ring_factor2x2": (2, "ring"), "ring": (1, "ring"), "gspmd": (1, "gspmd")},
    deflated=dict(DEFLATED["mid"], config=dict(kmax=384, tol=1e-8), layout="ring", storage="twopass"),
)


def digest(*tensors):
    """sha256 over the dtype, shape and bytes of each tensor (or array)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        t = torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) else t
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def recorded_recurrence():
    """Digests of the Lanczos α and β of the solves run inside: solve()'s
    projected H at its end (its diagonal and subdiagonal up to the last
    step), and the deflated solve's T (dg, od) at its last checkpoint."""
    from tensorkrylov_tpu_torch import deflate, solver

    seen, finalize, evaluate = {}, solver._finalize, deflate._evaluate

    def finalize_(p, c):
        k = c.k - 1
        seen["alpha_beta"] = digest(torch.diagonal(c.H, dim1=1, dim2=2)[:, :k],
                                    torch.diagonal(c.H, offset=-1, dim1=1, dim2=2)[:, :k])
        return finalize(p, c)

    def evaluate_(dg, od, btil, boundary, ck, *rest):
        seen["alpha_beta"] = digest(dg[:, :ck], od[:, :ck + 1])
        return evaluate(dg, od, btil, boundary, ck, *rest)

    solver._finalize, deflate._evaluate = finalize_, evaluate_
    try:
        yield seen
    finally:
        solver._finalize, deflate._evaluate = finalize, evaluate


def multihost_run(tkt, run, dev):
    """One solve with the launch and traffic counts set to 0 just before it:
    (result, its summary: status, steps, the digests of α/β, the trace or
    bounds and x, wall, peak memory, launches, cross-process traffic)."""
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.parallel.sharding import comm_stats

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    comm_stats.clear()
    with recorded_recurrence() as seen:
        t0 = time.perf_counter()
        res = run()
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k = res.niterations
    if isinstance(res.relative_residual, torch.Tensor):
        trace = digest(res.relative_residual[:k + 1])
    else:
        trace = digest(np.asarray(res.relative_residual + res.certified_bound, np.float64))
    checks = len(res.checkpoints) if hasattr(res, "checkpoints") else len(checked(res))
    return res, dict(status=int(res.status), niterations=k, checks=checks, alpha_beta=seen["alpha_beta"], trace=trace,
                     x=digest(res.x.weights, res.x.factors), wall_s=wall, iterations_per_s=k / wall,
                     max_memory_allocated=peak_bytes(dev), launches=dict(_build.launches),
                     traffic=dict(comm_stats))


def multihost_cases(tkt, mesh_of, dev, p=MULTIHOST):
    """Each case of phase 15 on the meshes mesh_of(factor_parallel) give:
    name → its summary (multihost_run). One controller runs them on 4 slots
    of dev; each worker on its pod mesh."""
    from tensorkrylov_tpu_torch.parallel import shard_operator, shard_rhs

    out = {}
    cfg = tkt.SolverConfig(**CONFIGS["default"])
    # a process's first solve initialises the card's libraries: one, untimed, at a small size
    fp, comm = next(iter(p["layouts"].values()))
    op, b = slice_problem(tkt, 4096, dev)
    mesh = mesh_of(fp)
    tkt.solve(shard_operator(op, mesh, comm), shard_rhs(b, mesh, op.d), cfg)
    op, b = slice_problem(tkt, p["n"], dev)
    for name, (fp, comm) in p["layouts"].items():
        mesh = mesh_of(fp)
        sop, bs = shard_operator(op, mesh, comm), shard_rhs(b, mesh, op.d)
        res, out[name] = multihost_run(tkt, lambda: tkt.solve(sop, bs, cfg), dev)
        out[name].update(factor_parallel=fp, route=comm)
        del res, sop, bs
    del op, b
    q = p["deflated"]
    op, b = deflated_problem(tkt, q, dev)
    basis = tkt.deflation_basis(op, q["m"])
    fp, comm = p["layouts"][q["layout"]]
    res, out["deflated"] = multihost_run(tkt, lambda: tkt.solve_deflated(
        op, b, tkt.SolverConfig(**q["config"]), basis=basis, storage=q["storage"], mesh=mesh_of(fp), comm=comm),
        dev)
    out["deflated"].update(factor_parallel=fp, route=comm, storage=q["storage"], d=q["d"], n=q["n"], m=q["m"],
                           kappa=q["kappa"], certified_bound=res.certified_bound[-1])
    return out


def multihost_worker(rank, port, out_path, p):
    """One rank of phase 15 (python3 chip_smoke.py --multihost-worker RANK
    PORT OUT PARAMS, PARAMS phase 15's settings as JSON): the ring kernel
    with a received halo against its plain version, then every case,
    written to OUT as JSON."""
    import torch.distributed as dist

    import tensorkrylov_tpu_torch as tkt
    from tensorkrylov_tpu_torch.parallel import distribute_problem, init_distributed, make_pod_mesh
    from tensorkrylov_tpu_torch.parallel.halo import exchange_halos, spmv_sharded
    from tensorkrylov_tpu_torch.parallel.sharding import allgather

    # the two ranks share the host's cores: intra-op threads that would spin past them slow both
    torch.set_num_threads(p["threads"])
    init_distributed(f"localhost:{port}", 2, rank, p["slots"])
    dev = torch.device(p["device"])
    if dev.type == "cuda" and p["cards"] > 1:
        dev = torch.device("cuda", rank)      # a card per rank, as init_distributed chose it

    def pod(fp):
        # the card's slots by default; a rehearsal on the CPU names them
        return make_pod_mesh(factor_parallel=fp, devices=None if dev.type == "cuda" else [dev] * p["slots"])

    out = dict(rank=rank, backend=dist.get_backend(), world=dist.get_world_size())
    # the ring kernel in layout (b), whose right or left source is a received halo buffer
    fp, comm = p["layouts"]["ring"]
    mesh = pod(fp)
    op, _ = slice_problem(tkt, p["n"], dev)
    v = unit_rows(np.random.default_rng(16), (10, p["n"]), torch.float64, dev)
    sop, vs = distribute_problem(op, v, mesh, comm)
    got, ref = spmv_sharded(sop, vs), plain_sharded(sop, vs)
    out["devices"] = [str(d) for row in mesh.devices for d in row]
    out["ring_check"] = dict(shards=[sh.index for sh in sop.shards], max_abs_err=max(
        float((g - r).abs().max()) for g, r in zip(got, ref)), limit=0.0)
    # the mechanism's own cost with both ranks idle and in step: a psum-sized all-gather, and the slice's halo
    # exchange; in a solve the same calls also wait for the other rank's work on the shared card
    out["idle_ms"] = {}
    for name, call in (("allgather", lambda: allgather(mesh, [torch.ones(10, dtype=torch.float64, device=dev)]
                                                       * len(vs), "probe")),
                       ("halo_exchange", lambda: exchange_halos(sop, vs))):
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(p["probe_reps"]):
            call()
        out["idle_ms"][name] = 1e3 * (time.perf_counter() - t0) / p["probe_reps"]
    del op, v, sop, vs, got, ref
    out["cases"] = multihost_cases(tkt, pod, dev, p)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def run_pair(argvs, timeout, env=None):
    """Start the two ranks, wait for both with a timeout, kill both on
    timeout or when either fails; returns their stdouts."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
             for a in argvs]
    deadline, outs = time.monotonic() + timeout, [None, None]
    try:
        while any(o is None for o in outs):
            for i, proc in enumerate(procs):
                if outs[i] is None and proc.poll() is not None:
                    outs[i] = proc.communicate()
                    require(proc.returncode == 0, f"rank {i} exited {proc.returncode}: {outs[i][1][-3000:]}")
            require(time.monotonic() < deadline, f"the ranks did not finish within {timeout} s")
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return [o[0] for o in outs]


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_multihost(tkt, p=MULTIHOST):
    """Phase 15: every case on one controller over 4 slots of cuda:0, then
    the same cases by two worker ranks of 2 slots each on cuda:0 over gloo
    (multihost_worker): each must converge at the controller's step with
    α/β, trace and x bit-equal on both ranks and to the controller's; the
    ring kernel once per rank per SpMV, reading the remote edge from its
    received buffer; then parallel/_smoke.py as two ranks, their SMOKE lines
    equal. Returns the workers' (banded_spmv, ring_spmv) launches of the
    cases, both ranks'."""
    from tensorkrylov_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    dev = torch.device(p["device"])
    on_card = dev.type == "cuda"
    env = dict(os.environ)
    if on_card and p["cards"] == 1:
        # both ranks on the first card, whatever else the machine has
        env["CUDA_VISIBLE_DEVICES"] = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    backend = "nccl" if on_card and p["cards"] > 1 else "gloo"
    single = multihost_cases(tkt, lambda fp: make_mesh(devices=[dev] * 2 * p["slots"], factor_parallel=fp), dev, p)
    if on_card:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        port, paths = free_port(), [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        t0 = time.perf_counter()
        run_pair([[sys.executable, os.path.join(REPO, "chip_smoke.py"), "--multihost-worker", str(r), str(port),
                   paths[r], json.dumps(p)] for r in range(2)], p["worker_timeout"], env)
        workers_s = time.perf_counter() - t0
        ranks = []
        for path in paths:
            with open(path) as f:
                ranks.append(json.load(f))
    launched = {"banded_spmv": 0, "ring_spmv": 0, "tridiag_eigh": 0, "expsum_sup": 0}
    for r, out in enumerate(ranks):
        # the backend rule: gloo where the ranks share a card, NCCL for a card each
        require(out["backend"] == backend and out["world"] == 2, f"rank {r}: backend {out['backend']}")
        require(out["ring_check"]["max_abs_err"] == 0.0,
                f"rank {r}: the ring kernel with a received halo is {out['ring_check']['max_abs_err']} from plain")
        for name, ref in single.items():
            got = out["cases"][name]
            k = ref["niterations"]
            require(ref["status"] == tkt.Status.CONVERGED and (got["status"], got["niterations"]) == (ref["status"], k),
                    f"multihost {name} rank {r}: {got['status']}/{got['niterations']} vs one controller "
                    f"{ref['status']}/{k}")
            for key in ("alpha_beta", "trace", "x"):
                require(got[key] == ref[key], f"multihost {name} rank {r}: {key} differs from one controller's")
            if name == "deflated":
                # both passes, the cross-check, and the sup error on the rank's lead
                want = {"ring_spmv": 2 * k - 1, "banded_spmv": 1, **sup_launches(dev)}
            elif got["route"] == "ring":
                want = {"ring_spmv": k}                                   # one launch per rank and SpMV
            else:
                want = {"banded_spmv": p["slots"] * k}                    # one per shard and SpMV
            want.update(eigh_launches(dev, got["checks"]))               # every rank's projected stage
            require(got["launches"] == want or not on_card,
                    f"multihost {name} rank {r}: launches {got['launches']}, want {want}")
            # 'mode' across the processes (factor_parallel=1): one halo exchange per SpMV; else none
            traffic, spmvs = got["traffic"], want.get("ring_spmv", k)
            require(traffic.get("halo_calls", 0) == (spmvs if got["factor_parallel"] == 1 else 0)
                    and traffic.get("psum_calls", 0) > 0 and traffic.get("gather_calls", 0) > 0,
                    f"multihost {name} rank {r}: traffic {traffic}")
            for kernel, c in tally(got["launches"]).items():
                launched[kernel] += c
    # parallel/_smoke.py at its own size, one rank per process on the card
    port = free_port()
    t0 = time.perf_counter()
    outs = run_pair([[sys.executable, "-m", "tensorkrylov_tpu_torch.parallel._smoke", "--coordinator",
                      f"localhost:{port}", "--num-processes", "2", "--process-id", str(r), "--local-devices",
                      str(p["slots"])] + ([] if on_card else ["--cpu"]) for r in range(2)], p["smoke_timeout"], env)
    smoke_s = time.perf_counter() - t0
    lines = [next((ln for ln in o.splitlines() if ln.startswith("SMOKE ")), None) for o in outs]
    require(lines[0] is not None and lines[0] == lines[1] and lines[0].startswith("SMOKE 1 "),
            f"_smoke: {lines}")

    def per_rank(name):
        rows = []
        for out in ranks:
            got = out["cases"][name]
            k, comm = got["niterations"], got["traffic"]
            rows.append(dict(rank=out["rank"], wall_s=got["wall_s"], iterations_per_s=got["iterations_per_s"],
                             max_memory_allocated=got["max_memory_allocated"], launches=got["launches"],
                             halo_ms_per_step=1e3 * comm.get("halo_s", 0.0) / k,
                             psum_allgather_ms_per_step=1e3 * comm.get("psum_s", 0.0) / k,
                             psum_allgathers_per_step=comm.get("psum_calls", 0) / k,
                             gather_ms=1e3 * comm.get("gather_s", 0.0), gathers=comm.get("gather_calls", 0),
                             bytes={kind: comm.get(f"{kind}_bytes", 0) for kind in ("halo", "psum", "gather")},
                             host_staged_bytes=sum(comm.get(f"{kind}_host_bytes", 0)
                                                   for kind in ("halo", "psum", "gather"))))
        return rows

    cases = {name: dict(factor_parallel=ref["factor_parallel"], comm=ref["route"], status=ref["status"],
                        niterations=ref["niterations"], bit_equal=True,
                        one_controller=dict(wall_s=ref["wall_s"], iterations_per_s=ref["iterations_per_s"],
                                            max_memory_allocated=ref["max_memory_allocated"],
                                            launches=ref["launches"]),
                        ranks=per_rank(name),
                        **({k: ref[k] for k in ("storage", "d", "n", "m", "kappa", "certified_bound")}
                           if name == "deflated" else dict(d=10, n=p["n"])))
             for name, ref in single.items()}
    emit("multihost", processes=2, slots_per_rank=p["slots"], devices=ranks[0]["devices"], backend=ranks[0]["backend"],
         ring_check=[out["ring_check"] for out in ranks], idle_ms=[out["idle_ms"] for out in ranks], cases=cases,
         smoke_line=lines[0], smoke_s=smoke_s,
         workers_s=workers_s, launches=launched, seconds=time.perf_counter() - t_phase)
    return launched["banded_spmv"], launched["ring_spmv"]


# phase 16: the rows of tests/test_torch_expsum_sup.py, (κ, coefficient tolerance); the flagship's is the
# deflated cells' 0.5·tol/κ at κ ≈ 1.05e6, the rank-47 row
EXPSUM_SUP = dict(rows=[(1e2, 1e-8 / 1e2), (1e3, 1e-10), (1e6, 0.5e-8 / 1e6), (1.05e6, 0.5e-8 / 1.05e6),
                        (1e7, 0.5e-8 / 1e7)],
                  flagship=3, reps=200, plain_reps=3, host_reps=2)
EXPSUM_SUP_ATOL = 1e-17   # kernel vs the host longdouble function (its own error is ~1e-19)


def phase_expsum_sup(tkt, dev=torch.device("cuda"), p=EXPSUM_SUP):
    """Phase 16: the sup error's kernel at every row against its plain
    version on the card (limit 0.0) and the host function (EXPSUM_SUP_ATOL),
    one launch a call; at the flagship's row, timed. Returns the kernels
    line's entry."""
    from tensorkrylov_tpu_torch import deflate
    from tensorkrylov_tpu_torch.coeffs.tables import load_tables, select_bh
    from tensorkrylov_tpu_torch.ops import _build, expsum

    t_phase = time.perf_counter()
    tables = load_tables()
    rows, worst = [], 0.0
    for kappa, tol in p["rows"]:
        co = select_bh(torch.tensor(kappa, dtype=torch.float64), tol, tables)
        om, al = expsum._terms(co.omega, co.alpha)
        h = expsum._grid_step(kappa, expsum.N_GRID)
        _build.launches.clear()
        got = expsum.expsum_sup_error_dd(co.omega, co.alpha, kappa, expsum.N_GRID, device=dev)
        launches = dict(_build.launches)
        plain = float(expsum._sup_residuals(om, al, h, expsum.N_GRID, dev).max())
        host = deflate.expsum_sup_error(co.omega, co.alpha, kappa, expsum.N_GRID)
        worst = max(worst, abs(got - plain))
        rows.append(dict(kappa=kappa, coeff_tol=tol, rank=int(co.rank), sup=got, plain=plain, host=host,
                         abs_err_vs_host=abs(got - host), launches=launches,
                         flops=expsum.expsum_sup_ops(co.omega, co.alpha, kappa, expsum.N_GRID)))
        require(launches == {"expsum_sup": 1}, f"expsum_sup κ={kappa}: launches {launches}")
        require(got == plain, f"expsum_sup κ={kappa}: kernel {got!r} vs plain {plain!r}")
        require(abs(got - host) <= EXPSUM_SUP_ATOL, f"expsum_sup κ={kappa}: kernel {got!r} vs host {host!r}")

    kappa, tol = p["rows"][p["flagship"]]
    co = select_bh(torch.tensor(kappa, dtype=torch.float64), tol, tables)
    om, al = expsum._terms(co.omega, co.alpha)
    h = expsum._grid_step(kappa, expsum.N_GRID)
    ms = time_one(lambda: expsum._sup_cuda(om, al, h, expsum.N_GRID, dev), reps=p["reps"])
    t0 = time.perf_counter()
    for _ in range(p["reps"]):
        expsum.expsum_sup_error_dd(co.omega, co.alpha, kappa, expsum.N_GRID, device=dev)
    call_ms = (time.perf_counter() - t0) / p["reps"] * 1e3
    plain_ms = time_one(lambda: expsum._sup_residuals(om, al, h, expsum.N_GRID, dev), reps=p["plain_reps"], warm=1)
    t0 = time.perf_counter()
    for _ in range(p["host_reps"]):
        deflate.expsum_sup_error(co.omega, co.alpha, kappa, expsum.N_GRID)
    host_ms = (time.perf_counter() - t0) / p["host_reps"] * 1e3
    flagship = dict(rows[p["flagship"]], ms=ms, call_ms=call_ms, plain_ms=plain_ms, host_ms=host_ms,
                    **bound(8 + 2 * 8 * int(om.numel()), rows[p["flagship"]]["flops"], torch.float64))
    emit("expsum_sup", rows=rows, flagship=flagship, seconds=time.perf_counter() - t_phase)
    return dict(max_abs_err=worst, **{k: flagship[k] for k in (
        "ms", "call_ms", "plain_ms", "host_ms", "bound_ms", "bound_by", "rank", "kappa")})


HESS_EIG = dict(d=10, n=131072, c=10.0, kappa=1e4, K=385, steps=304, ks=(16, 64, 128, 304),
                twin_ks=(16, 64, 128, 304), reps=5, eig_reps=2, plain_k=16, res_limit=1e-12, w_limit=1e-10,
                main=dict(kmax=384, tol=1e-8, tmax=513, check_every=16, checks=19),
                solve=dict(d=3, n=30, kmax=30, tol=1e-8, tmax=601, check_every=3))


def phase_hess_eig(tkt, dev=torch.device("cuda"), p=HESS_EIG):
    """Phase 17: the Hessenberg eigensolver's kernel on the Arnoldi cell's
    H against torch.linalg.eig and its plain version, timed beside them;
    then the main path, the cell's own solve (conv_diff d=10, n=131072,
    Arnoldi, kmax 384, check_every 16), with its launches, the calls of
    torch.linalg.eig and its true residual on the card; and a small
    nonsymmetric solve against the dense oracle. Returns the kernels line's
    entry, whose launches are the main path's."""
    from tensorkrylov_tpu_torch.ops import _build
    from tensorkrylov_tpu_torch.ops import hess_eig as he
    from tensorkrylov_tpu_torch.ops.orth import arnoldi_step, init_state
    from tensorkrylov_tpu_torch.utils.cp import cp_residual_cross_check_device

    t_phase = time.perf_counter()
    d, n, K = p["d"], p["n"], p["K"]
    op = tkt.conv_diff(d, n, c=p["c"], shift=sigma_for_kappa(n, p["kappa"]), device=dev)
    b = tkt.random_rhs(d, n, seed=11, identical=False, device=dev)
    st, _ = init_state(op, b, K - 1, torch.float64)
    for k in range(1, p["steps"] + 1):
        st, _ = arnoldi_step(op, st, b, k, proj_dtype=torch.float64)
    H = st.H.clone()
    del st
    torch.cuda.empty_cache()

    def match(w, ref):
        w, used, worst = w.cpu().numpy(), np.zeros(w.numel(), bool), 0.0
        for z in ref.cpu().numpy():
            dist = np.where(used, np.inf, np.abs(w - z))
            j = int(np.argmin(dist))
            used[j] = True
            worst = max(worst, float(dist[j]))
        return worst

    rows = []
    for k in p["ks"]:
        _build.launches.clear()
        w, Z, X, info, stats = he._hess_eig_cuda(H, k, stats=True)
        V = he._vectors(Z, X)[0]
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        A = torch.triu(H[:, :k, :k], -1)
        nrm = torch.linalg.matrix_norm(A)
        res = float((torch.linalg.matrix_norm(A.to(V.dtype) @ V - V * w[:, None, :]) / nrm).max())
        ref = torch.linalg.eigvals(A)
        w_err = max(match(w[f], ref[f]) / float(nrm[f]) for f in range(d))
        row = dict(k=k, launches=launches, info=info.tolist(), iterations=stats[:, 0].tolist(),
                   bulge_steps=stats[:, 1].tolist(), flops=int(stats[:, 2].sum()), residual=res, w_err_vs_eig=w_err,
                   complex_pairs=int((w.imag > 0).sum()))
        if k in p["twin_ks"]:
            pw, _, _, _, pstats = he._hess_eig_plain(H[:1].cpu(), k)
            row["w_err_vs_plain"] = match(w[0], pw[0]) / float(nrm[0])
            row["plain_iterations"] = int(pstats[0, 0])
        emit("hess_eig_check", **row)
        require(launches == {"hess_eig": 1}, f"hess_eig k={k}: launches {launches}")
        require(not bool(info.any()), f"hess_eig k={k}: info {info.tolist()}")
        require(res <= p["res_limit"], f"hess_eig k={k}: residual {res}")
        require(w_err <= p["w_limit"] and row.get("w_err_vs_plain", 0.0) <= p["w_limit"],
                f"hess_eig k={k}: eigenvalues off by {w_err}, {row.get('w_err_vs_plain')}")
        row["kernel_ms"] = time_one(lambda: he._hess_eig_cuda(H, k), reps=p["reps"], warm=1)
        row["ms"] = time_one(lambda: he.hess_eig(H, k), reps=p["reps"], warm=1)
        Ak = A.contiguous()
        row["library_ms"] = time_one(lambda: torch.linalg.eig(Ak), reps=p["eig_reps"], warm=1)
        row.update(bound(0, row["flops"], torch.float64))
        rows.append(row)
    Hm = torch.triu(H, -1)
    padded_ms = time_one(lambda: torch.linalg.eig(Hm), reps=p["eig_reps"], warm=1)
    Hp = H[:, :p["plain_k"] + 1, :p["plain_k"] + 1].contiguous()
    t0 = time.perf_counter()
    he.hess_eig_reference(Hp, p["plain_k"])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    def counted_solve(sop, sb, q):
        """tkt.solve on the card with its launches, its torch.linalg.eig
        calls and its checks."""
        cfg = tkt.SolverConfig(kmax=q["kmax"], tol=q["tol"], orth="arnoldi", tmax=q["tmax"],
                               check_every=q["check_every"])
        eig_calls = []
        real_eig = torch.linalg.eig
        torch.linalg.eig = lambda A_: eig_calls.append(1) or real_eig(A_)
        try:
            _build.launches.clear()
            t0 = time.perf_counter()
            res = tkt.solve(sop, sb, cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = dict(_build.launches)
        finally:
            torch.linalg.eig = real_eig
        checks = sum(1 for k in range(1, res.niterations + 1) if k % cfg.check_every == 0 or k >= cfg.kmax)
        out = dict(niterations=res.niterations, status=int(res.status), checks=checks, launches=launches,
                   eig_calls=len(eig_calls), estimate=float(res.relative_residual[res.niterations]), seconds=secs)
        return res, out

    # the main path: the Arnoldi cell's solve (the b that built H), one launch a check
    q = p["main"]
    res, main = counted_solve(op, b, q)
    act = torch.nonzero(res.x.weights).flatten()
    check = cp_residual_cross_check_device(op, res.x.weights[act], res.x.factors[:, :, act], b)
    b_norm = float(torch.prod(torch.linalg.vector_norm(b, dim=1)))
    main.update(true_residual=check.value / b_norm, floor=check.floor / b_norm)
    del res, op, b
    torch.cuda.empty_cache()
    emit("hess_eig_main", **main)
    require(main["status"] == int(tkt.Status.CONVERGED) and main["true_residual"] <= q["tol"],
            f"hess_eig main path: status {main['status']}, true residual {main['true_residual']}")
    require(main["launches"].get("hess_eig") == main["checks"] == q["checks"] and main["eig_calls"] == 0,
            f"hess_eig main path: {main['launches']} for {main['checks']} checks (expected {q['checks']}), "
            f"torch.linalg.eig {main['eig_calls']}")

    # a small solve against the dense oracle
    q = p["solve"]
    sop, sb = tkt.conv_diff(q["d"], q["n"], device=dev), tkt.random_rhs(q["d"], q["n"], seed=7, device=dev)
    res, small = counted_solve(sop, sb, q)
    small["oracle"] = tkt.kron_residual_dense(sop, res.x, sb)
    require(small["status"] == int(tkt.Status.CONVERGED) and small["oracle"] <= q["tol"],
            f"hess_eig solve: {small['status']}, {small['oracle']}")
    require(small["launches"].get("hess_eig") == small["checks"] and small["eig_calls"] == 0,
            f"hess_eig solve: {small['launches']} for {small['checks']} checks, torch.linalg.eig "
            f"{small['eig_calls']}")
    top = rows[-1]
    emit("hess_eig", rows=rows, padded_library_ms=padded_ms, plain_ms=plain_ms, plain_k=p["plain_k"], main=main,
         solve=small, seconds=time.perf_counter() - t_phase)
    return dict(launches=main["launches"]["hess_eig"], checks=main["checks"], k=top["k"], ms=top["ms"],
                kernel_ms=top["kernel_ms"],
                bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"], padded_library_ms=padded_ms,
                plain_ms=plain_ms, plain_k=p["plain_k"], max_residual=max(r["residual"] for r in rows))


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
        phase_tables(tkt)
        phase_build()
        worst, times, extra = phase_kernels(tkt)
        phase_golden(tkt)
        launches, slice_trace = phase_slice(tkt)
        phase_card_vs_cpu(tkt)
        launches["resident_lanczos"] = phase_host_projected(tkt)
        shared = {}
        launches["resident_spmv"] = phase_entry_points(tkt, slice_trace, keep=shared)
        ring_launches, ring_times, worst["ring_spmv"] = phase_sharded(tkt)
        phase_solvers(tkt)
        launches["banded_spmv"] += phase_deflated(tkt, keep=shared)
        launches["banded_spmv"] += phase_recorded(tkt, keep=shared)
        banded, ring = phase_sharded_deflated(tkt, keep=shared)
        launches["banded_spmv"] += banded
        ring_launches["ring_spmv"] += ring
        banded, ring = phase_sharded_solvers(tkt, keep=shared)
        launches["banded_spmv"] += banded
        ring_launches["ring_spmv"] += ring
        banded, ring = phase_multihost(tkt)
        launches["banded_spmv"] += banded
        ring_launches["ring_spmv"] += ring
        sup = phase_expsum_sup(tkt)
        hess = phase_hess_eig(tkt)
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
    kernels.append(dict(name="tridiag_eigh", route="cuda", source=f"{pkg}/tridiag_eigh.cu",
                        replaces="tensorkrylov_tpu/ops/eigen.py:182", launches=MAIN_TALLY["tridiag_eigh"],
                        max_abs_err=worst["tridiag_eigh"], ms=times["tridiag_eigh"][0],
                        plain_ms=times["tridiag_eigh"][1], **extra["tridiag_eigh"]))
    kernels.append(dict(name="expsum_sup", route="cuda", source=f"{pkg}/expsum_sup.cu",
                        replaces="none: tensorkrylov_tpu/deflate.py:448 on the host",
                        launches=MAIN_TALLY["expsum_sup"], **sup))
    kernels.append(dict(name="hess_eig", route="cuda", source=f"{pkg}/hess_eig.cu",
                        replaces="none: torch.linalg.eig in ops/expsum.py cp_solve_nonsym_eig (the JAX package's "
                        "tensorkrylov_tpu/ops/expsum.py calls jnp.linalg.eig there)", **hess))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], json.loads(sys.argv[5])))
    sys.exit(main())
