"""Offline packer for the Braess–Hackbusch exponential-sum tables:
counterpart of ``tensorkrylov_tpu/coeffs/preprocess.py``.

The reference ships ~2 771 text files of optimal coefficients for
approximating 1/x on [1, R] plus an error-index CSV. This packer parses them
once into the npz that ``tables.load_tables`` reads
(``coeffs/data/bh_tables.npz`` beside this module):

  R_values (nR,)              — available condition numbers, ascending
  err      (nR, tmax)         — best uniform error of the rank-(j+1) sum on
                                [1, R]; inf where no table/file exists
  omega    (nR, tmax, tmax)   — ω coefficients, omega[r, j, :j+1] valid
  alpha    (nR, tmax, tmax)   — α coefficients
  grid     (10, n_orders)     — (first_digit, order) → row index, int32, with
                                the reference's increment-digit-until-exists
                                fallback baked in; a digit range absent from
                                a whole decade falls through to the next
                                decade (the reference would loop forever)

Each ``1_xk{t:02d}.{digit}_{order}`` file has t lines of ω then t lines of α,
one float (40 digits) per line with a ``{omega[i]}``/``{alpha[i]}`` label.
numpy only: given the same source directory, the arrays are bit-equal to the
JAX package's packer's.

Run: python -m tensorkrylov_tpu_torch.coeffs.preprocess [src_dir] [out.npz]
(src_dir: the reference repository's ``coefficients_data`` directory; by
default ``coefficients_data`` under the working directory).
"""
from __future__ import annotations

import math
import os
import sys

import numpy as np

TMAX = 63
DEFAULT_SRC = "coefficients_data"
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "bh_tables.npz")

__all__ = ["TMAX", "DEFAULT_SRC", "DEFAULT_OUT", "parse_coefficient_file", "digit_order_of", "pack"]


def parse_coefficient_file(path: str, t: int):
    """Parse one ``1_xk`` file → (omega (t,), alpha (t,)) float64."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                vals.append(float(line.split("{")[0].strip()))
    if len(vals) != 2 * t:
        raise ValueError(f"{path}: expected {2 * t} values, got {len(vals)}")
    return np.array(vals[:t]), np.array(vals[t:])


def digit_order_of(R: float):
    """R → (first significant digit, decimal order)."""
    order = int(math.floor(math.log10(R)))
    digit = int(math.floor(R / 10.0**order))
    return digit, order


def _read_error_table(csv_path: str):
    """The CSV's rows (R, err_1, err_2, ...), sorted by R; 'inf' entries → inf."""
    rows = []
    with open(csv_path) as f:
        f.readline()  # header
        for line in f:
            parts = line.strip().split(",")
            if parts and parts[0]:
                rows.append([np.inf if x.lower() == "inf" else float(x) for x in parts])
    rows.sort(key=lambda r: r[0])
    return rows


def _row_grid(R_values: np.ndarray) -> np.ndarray:
    """(digit, order) → table row: the exact (digit, order) of a tabulated R,
    else the next digit up, else the next decade's first, else the last row."""
    nR = len(R_values)
    max_order = int(math.floor(math.log10(R_values[-1])))
    exact = {digit_order_of(R): i for i, R in enumerate(R_values)}
    grid = np.zeros((10, max_order + 1), np.int32)
    for order in range(max_order + 1):
        for digit in range(10):
            dd, oo = max(digit, 1), order
            row = exact.get((dd, oo))
            while row is None:
                dd += 1
                if dd > 9:
                    dd, oo = 1, oo + 1
                row = nR - 1 if oo > max_order else exact.get((dd, oo))
            grid[digit, order] = row
    return grid


def pack(src_dir: str = DEFAULT_SRC, out_path: str = DEFAULT_OUT) -> dict:
    """Parse ``src_dir``'s error CSV and coefficient files and write the
    tables to ``out_path`` (np.savez_compressed). An error tabulated for a
    rank whose coefficient file is missing becomes inf: never selectable."""
    raw = _read_error_table(os.path.join(src_dir, "output_data", "tabelle_complete.csv"))
    nR = len(raw)
    R_values = np.array([r[0] for r in raw])
    err = np.full((nR, TMAX), np.inf)
    for i, r in enumerate(raw):
        vals = r[1 : 1 + TMAX]
        err[i, : len(vals)] = vals

    omega = np.zeros((nR, TMAX, TMAX))
    alpha = np.zeros((nR, TMAX, TMAX))
    n_files = 0
    for i in range(nR):
        digit, order = digit_order_of(R_values[i])
        for j in range(TMAX):
            if not np.isfinite(err[i, j]):
                continue
            t = j + 1
            fname = os.path.join(src_dir, f"1_xk{t:02d}.{digit}_{order}")
            if not os.path.exists(fname):
                err[i, j] = np.inf
                continue
            omega[i, j, :t], alpha[i, j, :t] = parse_coefficient_file(fname, t)
            n_files += 1

    grid = _row_grid(R_values)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, R_values=R_values, err=err, omega=omega, alpha=alpha, grid=grid)
    return {"nR": nR, "n_files": n_files, "n_orders": grid.shape[1], "out": out_path,
            "bytes": os.path.getsize(out_path)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    src = argv[0] if len(argv) > 0 else DEFAULT_SRC
    out = argv[1] if len(argv) > 1 else DEFAULT_OUT
    print(pack(src, out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
