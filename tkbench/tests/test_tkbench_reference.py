"""The plain reference: its residual and its solver against dense Kronecker
algebra, its independence from the program, and the control that the
comparison has to reject."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from tkbench import control  # noqa: E402
from tkbench.reference import reaction_diffusion as rd, residual  # noqa: E402
import tkbench_tiny  # noqa: E402

torch.set_num_threads(1)


def dense_factor(n, sigma):
    h2 = (n + 1) ** 2
    return np.diag(np.full(n, 2.0 * h2 + sigma)) - h2 * (np.eye(n, k=1) + np.eye(n, k=-1))


def dense_sum(A1, d):
    n = A1.shape[0]
    return sum(np.kron(np.kron(np.eye(n ** s), A1), np.eye(n ** (d - s - 1))) for s in range(d))


def full(weights, factors):
    d = factors.shape[0]
    out = 0.0
    for j in range(weights.shape[0]):
        term = np.array([weights[j]])
        for s in range(d):
            term = np.multiply.outer(term, factors[s, :, j]).reshape(-1)
        out = out + term
    return out


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_residual_equals_the_dense_kronecker_residual(d):
    n, sigma = 8, rd.sigma_for_kappa(8, 1e2)
    g = torch.Generator().manual_seed(d)
    w = torch.randn(5, generator=g, dtype=torch.float64)
    X = torch.randn(d, n, 5, generator=g, dtype=torch.float64)
    b = torch.rand(d, n, generator=g, dtype=torch.float64)
    A = dense_sum(dense_factor(n, sigma), d)
    bf = full(np.ones(1), b.numpy()[:, :, None])
    dense = np.linalg.norm(A @ full(w.numpy(), X.numpy()) - bf) / np.linalg.norm(bf)
    got = residual.relative_residual(rd.OFFSETS, rd.bands(d, n, sigma), w, X, b)
    assert got == pytest.approx(dense, rel=1e-12)


def test_reference_solve_agrees_with_a_dense_kronecker_solve():
    d, n = 3, 8
    sigma = rd.sigma_for_kappa(n, 1e2)
    b = torch.rand(d, n, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    w, X = rd.solve(d, n, sigma, b)
    A = dense_sum(dense_factor(n, sigma), d)
    bf = full(np.ones(1), b.numpy()[:, :, None])
    x = np.linalg.solve(A, bf)
    assert np.linalg.norm(full(w.numpy(), X.numpy()) - x) / np.linalg.norm(x) < 1e-10
    # the small true residual is read to its last digits, where a Gram of the terms floors near 1e-8
    tt = residual.relative_residual(rd.OFFSETS, rd.bands(d, n, sigma), w, X, b)
    dense = np.linalg.norm(A @ full(w.numpy(), X.numpy()) - bf) / np.linalg.norm(bf)
    assert tt < 1e-10 and tt == pytest.approx(dense, rel=1e-3)


def test_dst_is_orthonormal():
    x = torch.randn(3, 17, dtype=torch.float64)
    assert torch.allclose(rd.dst(rd.dst(x)), x, atol=1e-14)
    lam = rd.eigenvalues(17, 5.0)
    A = torch.tensor(dense_factor(17, 5.0))
    S = rd.dst(torch.eye(17, dtype=torch.float64))
    assert torch.allclose(S @ A @ S, torch.diag(lam), atol=1e-9 * float(lam[-1]))


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((REPO / "tkbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_neither_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "tensorkrylov_tpu", "tensorkrylov_tpu_torch", "tkbench"}


def test_reference_loads_nothing_of_either_package():
    code = ("import sys; sys.path.insert(0, %r); from tkbench.reference import residual, reaction_diffusion; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tensorkrylov_tpu', 'tensorkrylov_tpu_torch'}))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


@pytest.mark.parametrize("cell", ["tiny.solve", "tiny.deflated_full", "tiny.sharded_ring4"])
def test_control_fails_and_reference_passes(tmp_path, cell):
    spec, root, bench = tkbench_tiny.make(tmp_path)
    low = control.control(spec, cell, 11, torch.float32, torch.device("cpu"), root, bench)
    assert not low["passes"] and low["checks"]["resid_max"]["value"] > 3e-8
    same = control.control(spec, cell, 11, torch.float64, torch.device("cpu"), root, bench)
    assert same["passes"] and same["checks"]["resid_max"]["value"] < 1e-10
