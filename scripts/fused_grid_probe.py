#!/usr/bin/env python3
"""Time the fused Lanczos core's two one-launch designs on one CUDA card: the
port's (one thread-block cluster of the plan's G blocks per factor, a cluster
barrier between the passes) against one cooperative grid (G blocks per
factor for every G whose d·G blocks the card holds at once, a grid-wide
barrier).

    python3 scripts/fused_grid_probe.py

It builds scripts/fused_grid_probe.cu, which includes ops/csrc/fused_lanczos.cu,
so both designs run the same kernel body from one library, into
build/fused_grid_probe/. At d=10, n=131072, tridiagonal, in f64 and f32, with
w in shared memory (where a block's part fits) and in u's row, it holds every
launch against the plain version bit for bit and times it: ms per launch over
200 back-to-back launches after 20 of warm-up (CUDA events; a launch costs
the host a few µs, less than the kernel, so the card stays busy). Prints one
JSON line.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import tensorkrylov_tpu_torch as tkt  # noqa: E402
from tensorkrylov_tpu_torch.ops import _build, fused_lanczos as fl  # noqa: E402

SRC = REPO / "scripts" / "fused_grid_probe.cu"
BUILD_DIR = REPO / "build" / "fused_grid_probe"
D, N = 10, 131072
GRID_SIZES = range(4, 17)  # blocks per factor tried for the grid
_SIG = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]


def _compile_into(tmpdir, out):
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", out, str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def library():
    inputs = [SRC, _build.CSRC / "fused_lanczos.cu", _build.CSRC / "tk_common.cuh"]
    path, log = _build.build_shared("fused_grid_probe", inputs, _build.NVCC_FLAGS, BUILD_DIR, _compile_into)
    sigs = {name: _SIG for name in ("probe_fused_grid_f32", "probe_fused_grid_f64",
                                    "tk_fused_lanczos_f32", "tk_fused_lanczos_f64")}
    sigs["probe_fused_grid_blocks"] = [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    return _build.load_shared(path, sigs, lambda name: ctypes.c_int), log


def main():
    if not torch.cuda.is_available():
        print("fused_grid_probe: no CUDA device", file=sys.stderr)
        return 1
    lib, log = library()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    lap = tkt.laplace(D, N, device=dev)
    out = {"d": D, "n": N, "ptxas": [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        elt = dtype.itemsize
        op = tkt.KroneckerSumOperator((lap.bands / (4.0 * (N + 1) ** 2)).to(dtype), lap.offsets)
        rng = np.random.default_rng(12)
        v, v_pprev, b = (torch.tensor(rng.standard_normal((D, N)), dtype=dtype, device=dev) for _ in range(3))
        beta = torch.full((D,), 0.5, dtype=dtype, device=dev)
        ref = fl.fused_lanczos_core_reference(op, v, v_pprev, beta, b)
        u = torch.empty((D, N), dtype=dtype, device=dev)
        scratch = torch.empty(3 * D * (1 + -(-N // fl.BLOCK)), dtype=dtype, device=dev)
        nb = len(op.offsets)
        suffix = "f64" if dtype == torch.float64 else "f32"

        def launch(entry, G, w_shared):
            err = getattr(lib, f"{entry}_{suffix}")(
                op.bands.data_ptr(), op.offsets_tensor.data_ptr(), v.data_ptr(), v_pprev.data_ptr(),
                beta.data_ptr(), b.data_ptr(), u.data_ptr(), scratch.data_ptr(), D, nb, N, G, w_shared, stream)
            _build.check(err, entry)

        def timed(entry, G, w_shared):
            launch(entry, G, w_shared)
            torch.cuda.synchronize()
            sums = scratch[:3 * D].view(3, D)
            got = (u, sums[0], sums[1], sums[2])
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                raise SystemExit(f"{entry} {name} G={G} w_shared={w_shared}: the bits differ from the plain version")
            for _ in range(20):
                launch(entry, G, w_shared)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                launch(entry, G, w_shared)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 200

        G_plan = fl.fused_lanczos_plan(D, N, dtype, dev)
        row = {}
        for placement in ("shared", "u_row"):
            shared = placement == "shared"
            w_shared = lambda G: int(shared and fl._w_bytes(N, G, elt) > 0)
            cluster = dict(G=G_plan, w_shared=w_shared(G_plan), ms=timed("tk_fused_lanczos", G_plan, w_shared(G_plan)))
            grid = {}
            for G in GRID_SIZES:
                smem = fl._w_bytes(N, G, elt) if w_shared(G) else 0
                blocks = ctypes.c_int64(0)
                _build.check(lib.probe_fused_grid_blocks(smem, elt, ctypes.byref(blocks)), "probe_fused_grid_blocks")
                if D * G <= blocks.value:
                    grid[G] = dict(w_shared=w_shared(G), ms=timed("probe_fused_grid", G, w_shared(G)),
                                   co_resident_blocks=blocks.value)
            best = min(grid, key=lambda G: grid[G]["ms"]) if grid else None
            row[placement] = dict(cluster=cluster, grid_by_G=grid, grid_best_G=best)
        out[name] = row
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
