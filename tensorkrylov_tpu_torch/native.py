"""The host C++ banded SpMV: counterpart of ``tensorkrylov_tpu/native/__init__.py``.

It is the bench's CPU baseline (``bench.py``'s ``cpu_numpy_gnnz_s``). The
library is compiled from the repository's ``csrc/tkcore.cpp`` by ``g++`` at
first use, through ``ops/_build.build_shared``, into ``build/tk_torch_native/``
beside the package (the JAX package's module builds into ``csrc/`` and cannot
be imported without jax). Without a compiler, or when the build fails,
``banded_spmv`` takes the JAX module's numpy fallback; ``runtime()`` says which
one runs.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .ops._build import build_shared, load_shared

__all__ = ["available", "runtime", "banded_spmv", "build_info"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tkcore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "tk_torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-pthread")

# How the library was built or why it was not: path, or the compiler's error.
build_info: dict = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile(tmpdir: str, out: str) -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", out, str(SOURCE)], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout + proc.stderr


def _signatures() -> dict:
    out = {}
    for suffix, dt in (("f64", np.float64), ("f32", np.float32)):
        p = np.ctypeslib.ndpointer(dt, flags="C")
        out[f"tk_banded_spmv_{suffix}"] = [p, np.ctypeslib.ndpointer(np.int64, flags="C"), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int64, p, p, ctypes.c_int]
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once per process; None when it cannot be."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                path, _ = build_shared("tkcore", [SOURCE], CXX_FLAGS, BUILD_DIR, _compile)
                _lib = load_shared(path, _signatures(), lambda name: None)
                build_info.update(path=str(path), error=None)
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                build_info.update(path=None, error=str(e))
        return _lib


def available() -> bool:
    """Whether the C++ library is built and loaded (building it if need be)."""
    return _load() is not None


def runtime() -> str:
    """'native' (the C++ library) or 'numpy' (the fallback): what banded_spmv runs."""
    return "native" if available() else "numpy"


def banded_spmv(bands: np.ndarray, offsets, v: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """u[s] = A_s v[s] on the host. bands (d, nb, n), v (d, n), numpy arrays;
    nthreads = 0 uses every hardware thread."""
    lib = _load()
    bands = np.ascontiguousarray(bands)
    v = np.ascontiguousarray(v, dtype=bands.dtype)
    d, nb, n = bands.shape
    if lib is None:
        u = np.zeros_like(v)
        for b, o in enumerate(offsets):
            if o >= 0:
                u[:, : n - o] += bands[:, b, : n - o] * v[:, o:]
            else:
                u[:, -o:] += bands[:, b, -o:] * v[:, : n + o]
        return u
    u = np.empty_like(v)
    fn = lib.tk_banded_spmv_f64 if bands.dtype == np.float64 else lib.tk_banded_spmv_f32
    fn(bands, np.asarray(offsets, np.int64), nb, d, n, v, u, nthreads)
    return u
