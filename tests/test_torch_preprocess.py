"""The port's table packer (coeffs/preprocess.py) and its own tables file,
against the JAX package's packer and file. The source directory is a small
synthetic one in the reference's layout, so no reference data is needed."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tensorkrylov_tpu.coeffs import preprocess as jpre
from tensorkrylov_tpu_torch.coeffs import preprocess, tables

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tensorkrylov_tpu_torch"
KEYS = ("R_values", "err", "omega", "alpha", "grid")

# The synthetic error table: R → errors of ranks 1..5 ('inf' where none is tabulated). The rows are out of
# order; R = 5 has errors but none of its coefficient files (every entry becomes inf); R = 2 lacks the file
# of rank 5; decade 1 (R in [10, 100)) is absent, so its digits fall through to decade 2; digits 4-9 of
# decade 3 fall past the last decade to the last row.
ERRORS = {
    200.0: ["2.5e-1", "3.1e-3", "4.0e-5", "inf", "inf"],
    2.0: ["1.0e-1", "1.0e-2", "Inf", "1.0e-4", "1.0e-5"],
    5.0: ["2.0e-1", "2.0e-2", "2.0e-3", "inf", "inf"],
    3000.0: ["3.0e-1", "3.0e-2", "3.0e-3", "3.0e-4", "inf"],
    7.0: ["inf", "7.0e-2", "7.0e-3", "inf", "inf"],
}
MISSING = {(5.0, t) for t in range(1, 6)} | {(2.0, 5)}


def _forty_digits(rng):
    """A float written with 40 digits after the point, as the reference's files hold them."""
    return f"{rng.integers(0, 10)}." + "".join(str(x) for x in rng.integers(0, 10, 40))


def write_coefficient_file(path, t, rng):
    """A `1_xk` file: t lines of ω, then t lines of α, each with its label."""
    lines = [f"  {_forty_digits(rng)}   {{omega[{i + 1}]}}" for i in range(t)]
    lines += [f"  {_forty_digits(rng)}   {{alpha[{i + 1}]}}" for i in range(t)]
    Path(path).write_text("\n".join(lines) + "\n\n")


def make_source(root, seed=0):
    """The reference's layout: output_data/tabelle_complete.csv and the 1_xkTT.D_O files."""
    rng = np.random.default_rng(seed)
    (root / "output_data").mkdir(parents=True)
    rows = [",".join([repr(R), *errs]) for R, errs in ERRORS.items()]
    (root / "output_data" / "tabelle_complete.csv").write_text("R,k1,k2,k3,k4,k5\n" + "\n".join(rows) + "\n\n")
    for R, errs in ERRORS.items():
        digit, order = jpre.digit_order_of(R)
        for j, e in enumerate(errs):
            t = j + 1
            if e.lower() != "inf" and (R, t) not in MISSING:
                write_coefficient_file(root / f"1_xk{t:02d}.{digit}_{order}", t, rng)
    return root


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_bit_equal(a, b):
    assert sorted(a) == sorted(b) == sorted(KEYS)
    for k in KEYS:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_pack_is_bit_equal_to_the_jax_packer(tmp_path):
    """Same source directory, same arrays, bit for bit, and the same summary."""
    src = make_source(tmp_path / "src")
    info = preprocess.pack(str(src), str(tmp_path / "port" / "t.npz"))
    jinfo = jpre.pack(str(src), str(tmp_path / "jax" / "t.npz"))
    _assert_bit_equal(_arrays(tmp_path / "port" / "t.npz"), _arrays(tmp_path / "jax" / "t.npz"))
    assert {k: info[k] for k in ("nR", "n_files", "n_orders")} == {k: jinfo[k] for k in ("nR", "n_files", "n_orders")}
    assert info["out"] == str(tmp_path / "port" / "t.npz") and info["bytes"] > 0


def test_pack_semantics_on_the_synthetic_source(tmp_path):
    """inf where no file exists, the increment-digit fallback, a missing
    decade falling through, grid int32."""
    src = make_source(tmp_path / "src")
    out = tmp_path / "t.npz"
    info = preprocess.pack(str(src), str(out))
    z = _arrays(out)
    R = list(z["R_values"])
    assert R == sorted(ERRORS) and z["grid"].dtype == np.int32 and z["grid"].shape == (10, 4)
    assert info["n_files"] == sum(e.lower() != "inf" and (R_, j + 1) not in MISSING
                                  for R_, es in ERRORS.items() for j, e in enumerate(es))
    assert np.isinf(z["err"][R.index(5.0)]).all()
    assert np.isinf(z["err"][R.index(2.0), 4]) and z["err"][R.index(2.0), 3] == 1e-4
    assert np.isinf(z["err"][:, 5:]).all()
    assert not z["omega"][R.index(2.0), 4].any()
    row = {R_: i for i, R_ in enumerate(R)}
    assert z["grid"][2, 0] == row[2.0] and z["grid"][3, 0] == row[5.0] and z["grid"][6, 0] == row[7.0]
    assert z["grid"][0, 0] == z["grid"][1, 0] == row[2.0]          # digits 0, 1 start at digit 1, step up to 2
    assert z["grid"][8, 0] == z["grid"][9, 0] == row[200.0]        # past digit 9, decade 1 absent: decade 2
    assert (z["grid"][:, 1] == row[200.0]).all()                   # decade 1 absent altogether
    assert z["grid"][3, 2] == row[3000.0] and (z["grid"][4:, 3] == len(R) - 1).all()


@pytest.mark.parametrize("t", [1, 3, 7])
def test_parse_coefficient_file_matches_jax(tmp_path, t):
    path = tmp_path / f"1_xk{t:02d}.1_0"
    write_coefficient_file(path, t, np.random.default_rng(t))
    om, al = preprocess.parse_coefficient_file(str(path), t)
    jom, jal = jpre.parse_coefficient_file(str(path), t)
    assert om.dtype == al.dtype == np.float64 and om.shape == al.shape == (t,)
    assert om.tobytes() == jom.tobytes() and al.tobytes() == jal.tobytes()
    with pytest.raises(ValueError, match=f"expected {2 * (t + 1)} values, got {2 * t}"):
        preprocess.parse_coefficient_file(str(path), t + 1)


@pytest.mark.parametrize("R", [2.0, 9.99, 10.0, 12.5, 99.0, 1e3, 2e6, 7.5e12, 1.0000000001e6])
def test_digit_order_of_matches_jax(R):
    assert preprocess.digit_order_of(R) == jpre.digit_order_of(R)


def test_cli_writes_the_file(tmp_path):
    """python -m tensorkrylov_tpu_torch.coeffs.preprocess SRC OUT writes OUT,
    equal to pack's arrays."""
    src = make_source(tmp_path / "src")
    out = tmp_path / "cli" / "bh.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "tensorkrylov_tpu_torch.coeffs.preprocess", str(src), str(out)],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert out.is_file() and "'nR': 5" in proc.stdout
    preprocess.pack(str(src), str(tmp_path / "ref.npz"))
    _assert_bit_equal(_arrays(out), _arrays(tmp_path / "ref.npz"))


def test_the_port_reads_its_own_tables():
    """DEFAULT_NPZ and the packer's DEFAULT_OUT lie inside the port's package,
    and the file's arrays equal the JAX package's file, array by array."""
    path = Path(tables.DEFAULT_NPZ).resolve()
    assert path.is_relative_to(PORT) and path.is_file()
    assert Path(preprocess.DEFAULT_OUT).resolve() == path
    _assert_bit_equal(_arrays(path), _arrays(Path(jpre.DEFAULT_OUT)))
    assert preprocess.TMAX == jpre.TMAX == tables.TMAX


def _docstrings(tree):
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                out.add(id(first.value))
    return out


def _labels(tree):
    """The string parts of `replaces=` arguments: chip_smoke.py's file:line
    names of the TPU kernel each CUDA kernel replaces, labels never opened."""
    return {id(n) for node in ast.walk(tree) if isinstance(node, ast.keyword) and node.arg == "replaces"
            for n in ast.walk(node.value)}


def jax_path_strings(path):
    """The string constants of a file's code (docstrings and comments left
    out) that hold 'tensorkrylov_tpu' as a path component."""
    tree = ast.parse(Path(path).read_text(), str(path))
    skip = _docstrings(tree) | _labels(tree)
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in skip
            and "tensorkrylov_tpu" in re.split(r"[/\\]", node.value)]


def test_no_path_into_the_jax_package():
    """No module of the port and no line of chip_smoke.py builds a path into
    the JAX package's directory."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    found = {str(f.relative_to(REPO)): hits for f in files if (hits := jax_path_strings(f))}
    assert not found, found


def test_the_scan_sees_a_path_into_the_jax_package(tmp_path):
    """The scan finds each form such a path takes, and skips docstrings and the kernels line's labels."""
    bad = tmp_path / "bad.py"
    bad.write_text('"""Reads ``tensorkrylov_tpu/coeffs/data``."""\n'
                   'from pathlib import Path\n'
                   'A = Path(__file__).parents[2] / "tensorkrylov_tpu" / "coeffs"\n'
                   'B = "tensorkrylov_tpu/coeffs/data/bh_tables.npz"\n'
                   'C = dict(replaces="tensorkrylov_tpu/ops/pallas/ring_spmv.py:45")\n'
                   'D = f"{A}/tensorkrylov_tpu/x"\n')
    assert sorted(line for line, _ in jax_path_strings(bad)) == [3, 4, 6]
