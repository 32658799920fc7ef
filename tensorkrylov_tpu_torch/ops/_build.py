"""Build and load the port's CUDA kernels.

The sources in ``ops/csrc/`` are compiled by ``nvcc`` for Hopper (``sm_90a``),
one process per source, all at once, and linked into one shared library with
a plain C interface, which ``ctypes`` loads. The
build happens at the first kernel launch of a process, into
``build/tk_torch_kernels/`` beside the package; the library's name carries a
hash of the sources and flags, so an edited source is rebuilt and an unchanged
one is reused. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["kernels", "launches", "build_info", "check", "stream_of", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tk_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches per kernel name since the last clear(): each wrapper adds one
# where it launches its kernel, so a run can show that it went through them.
launches: collections.Counter = collections.Counter()

# The loaded library and how it was built (seconds, path, ptxas report).
build_info: dict = {}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "tk_banded_spmv_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tk_banded_spmv_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tk_fused_lanczos_f32": [_P] * 9 + [_I, _I, _I, _P],
    "tk_fused_lanczos_f64": [_P] * 9 + [_I, _I, _I, _P],
    "tk_fused_lanczos_block_elems": [],
    "tk_resident_lanczos_f32": [_P] * 10 + [_I] * 4 + [_P],
    "tk_resident_lanczos_block_elems": [],
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib_path = BUILD_DIR / f"libtk_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        build_info.update(seconds=0.0, path=str(lib_path), log="(reused)")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log = []
    # build under a temporary directory and name, and rename, so a parallel
    # process never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        # one nvcc per source, all started together, then one link
        objs = [os.path.join(tmpdir, p.stem + ".o") for p in cu]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[nvcc, *compile_flags, "-c", "-o", o, str(p)] for p, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        tmp_lib = os.path.join(tmpdir, lib_path.name)
        link = [nvcc, *NVCC_FLAGS, "-o", tmp_lib, *objs]
        for cmd, proc, out in zip(cmds, procs, outs):
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{log[-1]}")
        os.replace(tmp_lib, lib_path)
    build_info.update(seconds=time.perf_counter() - t0, path=str(lib_path), log="".join(log))
    return lib_path


def kernels() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64 if name.endswith("block_elems") else ctypes.c_int
            _lib = lib
        return _lib


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
