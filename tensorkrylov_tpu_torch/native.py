"""The host C++ runtime: counterpart of ``tensorkrylov_tpu/native/__init__.py``.

Three entry points: the banded SpMV, the bench's CPU baseline (``bench.py``'s
``cpu_numpy_gnnz_s``); ``dense_to_bands``, the band extraction of dense
factors; and ``parse_bh_file``, the reader of one Braess–Hackbusch coefficient
file. The library is compiled from the repository's ``csrc/tkcore.cpp`` by
``g++`` at first use, through ``ops/_build.build_shared``, into
``build/tk_torch_native/`` beside the package (the JAX package's module builds
into ``csrc/`` and cannot be imported without jax). Without a compiler, or
when the build fails, each entry point takes the JAX module's fallback: numpy
for the SpMV, ``models.gallery.dense_to_bands`` and
``coeffs.preprocess.parse_coefficient_file``; ``runtime()`` says which runs.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .coeffs.preprocess import parse_coefficient_file
from .models.gallery import dense_to_bands as _dense_to_bands_plain
from .ops._build import build_shared, load_shared

__all__ = ["available", "runtime", "banded_spmv", "dense_to_bands", "parse_bh_file", "build_info"]

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
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
    out = {}
    for suffix, dt in (("f64", np.float64), ("f32", np.float32)):
        p = np.ctypeslib.ndpointer(dt, flags="C")
        out[f"tk_banded_spmv_{suffix}"] = [p, i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, p, p, ctypes.c_int]
    out["tk_dense_to_bands_f64"] = [f64p, ctypes.c_int, ctypes.c_int64, i64p, ctypes.c_int, f64p]
    out["tk_detect_offsets_f64"] = [f64p, ctypes.c_int, ctypes.c_int64, np.ctypeslib.ndpointer(np.uint8, flags="C")]
    out["tk_parse_bh_file"] = [ctypes.c_char_p, ctypes.c_int, f64p, f64p]
    return out


_RESTYPES = {"tk_parse_bh_file": ctypes.c_int}


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once per process; None when it cannot be."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                path, _ = build_shared("tkcore", [SOURCE], CXX_FLAGS, BUILD_DIR, _compile)
                _lib = load_shared(path, _signatures(), _RESTYPES.get)
                build_info.update(path=str(path), error=None)
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                build_info.update(path=None, error=str(e))
        return _lib


def available() -> bool:
    """Whether the C++ library is built and loaded (building it if need be)."""
    return _load() is not None


def runtime() -> str:
    """'native' (the C++ library) or 'numpy' (the fallbacks): what banded_spmv,
    dense_to_bands and parse_bh_file run."""
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


def dense_to_bands(mats: np.ndarray) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Detect the nonzero diagonals of dense (d, n, n) factors and extract
    them: ((d, nb, n) f64 bands, offsets), as ``models.gallery.dense_to_bands``."""
    lib = _load()
    mats = np.ascontiguousarray(mats, np.float64)
    if mats.ndim != 3 or mats.shape[1] != mats.shape[2]:
        raise ValueError(f"dense_to_bands: mats must be (d, n, n), got {mats.shape}")
    if lib is None:
        return _dense_to_bands_plain(mats)
    d, n, _ = mats.shape
    nonzero = np.zeros(2 * n - 1, np.uint8)
    lib.tk_detect_offsets_f64(mats, d, n, nonzero)
    offsets = tuple(int(o) for o in np.nonzero(nonzero)[0] - (n - 1)) or (0,)
    bands = np.empty((d, len(offsets), n), np.float64)
    lib.tk_dense_to_bands_f64(mats, d, n, np.asarray(offsets, np.int64), len(offsets), bands)
    return bands, offsets


def parse_bh_file(path: str, t: int) -> Tuple[np.ndarray, np.ndarray]:
    """One Braess–Hackbusch coefficient file → (omega (t,), alpha (t,)) f64,
    as ``coeffs.preprocess.parse_coefficient_file``."""
    lib = _load()
    if lib is None:
        return parse_coefficient_file(path, t)
    omega = np.empty(t)
    alpha = np.empty(t)
    rc = lib.tk_parse_bh_file(os.fsencode(path), t, omega, alpha)
    if rc != 0:
        raise ValueError(f"tk_parse_bh_file({path!r}, {t}) failed with code {rc}")
    return omega, alpha
