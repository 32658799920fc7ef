"""Build and load the port's CUDA kernels.

The sources in ``ops/csrc/`` are compiled by ``nvcc`` for Hopper (``sm_90a``),
one process per source, all at once, and linked into one shared library with
a plain C interface, which ``ctypes`` loads. The
build happens at the first kernel launch of a process, into
``build/tk_torch_kernels/`` beside the package, through ``build_shared``, which
also builds the host library of ``native.py``. Nothing here runs when the
module is imported.
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
from typing import Tuple

import torch

__all__ = ["kernels", "launches", "build_info", "build_shared", "load_shared", "check", "stream_of", "NVCC_FLAGS"]

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
    "tk_fused_lanczos_f32": [_P] * 8 + [_I] * 5 + [_P],
    "tk_fused_lanczos_f64": [_P] * 8 + [_I] * 5 + [_P],
    "tk_fused_lanczos_block_elems": [],
    "tk_fused_lanczos_max_clusters": [_I, _I, _I, _P],
    "tk_resident_lanczos_f32": [_P] * 10 + [_I] * 6 + [_P],
    "tk_resident_lanczos_max_clusters": [_I, _I, _P],
    "tk_resident_lanczos_block_elems": [],
    "tk_resident_spmv_plan": [_I] * 5 + [_P],
    "tk_resident_spmv_f32": [_P] * 4 + [_I] * 7 + [ctypes.c_double, _P],
    "tk_resident_spmv_f64": [_P] * 4 + [_I] * 7 + [ctypes.c_double, _P],
    "tk_ring_spmv_f32": [_P, _I, _P] + [_I] * 5 + [_P],
    "tk_ring_spmv_f64": [_P, _I, _P] + [_I] * 5 + [_P],
    "tk_ring_spmv_max_shards": [],
    "tk_enable_peer_access": [_I, _I],
}
# entry points that return a count rather than a cudaError_t
_COUNTS = ("tk_fused_lanczos_block_elems", "tk_resident_lanczos_block_elems", "tk_ring_spmv_max_shards")


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


def build_shared(stem: str, inputs, flags, build_dir: Path, compile_into) -> Tuple[Path, str]:
    """The shared library ``build_dir/lib<stem>_<hash>.so``, where the hash
    covers the flags and each input's name and bytes: an edited input is
    rebuilt and an unchanged one reused. ``compile_into(tmpdir, out)`` builds
    it at ``out`` and returns the compiler's log; it runs under a temporary
    directory and the result is renamed into place, so a parallel process
    never loads a half-written library. Returns the path and the log
    (``"(reused)"`` when nothing was built)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in inputs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib_path = build_dir / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, "(reused)"
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmpdir:
        out = os.path.join(tmpdir, lib_path.name)
        log = compile_into(tmpdir, out)
        os.replace(out, lib_path)
    return lib_path, log


def load_shared(path: Path, signatures: dict, restype) -> ctypes.CDLL:
    """Load a library with ctypes and declare each entry point's argument
    types and its return type ``restype(name)``."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype(name)
    return lib


def _compile_kernels(tmpdir: str, out: str) -> str:
    """One nvcc per source, all started together, then one link."""
    cu, _ = _sources()
    nvcc = _nvcc()
    objs = [os.path.join(tmpdir, p.stem + ".o") for p in cu]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    cmds = [[nvcc, *compile_flags, "-c", "-o", o, str(p)] for p, o in zip(cu, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    log = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, log):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    link = [nvcc, *NVCC_FLAGS, "-o", out, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    log.append(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{log[-1]}")
    return "".join(log)


def kernels() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            cu, cuh = _sources()
            t0 = time.perf_counter()
            path, log = build_shared("tk_kernels", cu + cuh, NVCC_FLAGS, BUILD_DIR, _compile_kernels)
            build_info.update(seconds=time.perf_counter() - t0, path=str(path), log=log)
            _lib = load_shared(path, _SIGNATURES, lambda name: ctypes.c_int64 if name in _COUNTS else ctypes.c_int)
        return _lib


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
