"""The port's examples 01-03 (examples/0{1,2,3}_*_torch.py) on the CPU, in
process at small sizes: each runs through its own main(argv) with --cpu and
reports a solve of the expected status."""
import os
import runpy

import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.utils.cp import kron_residual_dense

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


def _main(name):
    return runpy.run_path(os.path.join(EXAMPLES, name), run_name="example")["main"]


def test_basic_solve_example(capsys):
    res = _main("01_basic_solve_torch.py")(["--cpu", "--d", "3", "--n", "40"])
    assert res.status == tkt.Status.CONVERGED and res.x.factors.device.type == "cpu"
    out = capsys.readouterr().out
    assert "solution CP rank:" in out
    b = tkt.random_rhs(3, 40, seed=0)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    assert kron_residual_dense(tkt.laplace(3, 40, device="cpu"), res.x, b) < 1e-8


def test_nonsymmetric_example(capsys):
    """Arnoldi with the tmax=201 sinc rule exhausts the Krylov space (k = n):
    its estimate stops at the rule's own error, 1.7e-7, as the JAX example's
    does, while the dense oracle reads the true residual far below it."""
    res = _main("02_nonsymmetric_torch.py")(["--cpu", "--d", "3", "--n", "30"])
    assert res.config.orth == "arnoldi" and res.status == tkt.Status.MAXITER and res.niterations == 30
    b = tkt.random_rhs(3, 30, seed=1)
    b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True)
    true = kron_residual_dense(tkt.conv_diff(3, 30, c=10.0, device="cpu"), res.x, b)
    assert true < 1e-8 < float(res.relative_residual[30]) < 1e-6
    assert "MAXITER after 30 iterations" in capsys.readouterr().out


def test_sharded_example(capsys):
    res, rd = _main("03_sharded_torch.py")(["--cpu", "--d", "2", "--n", "64"])
    out = capsys.readouterr().out
    assert "mesh: {'factor': 2, 'mode': 2}" in out and "solve_sharded: status=" in out
    assert res.status == tkt.Status.CONVERGED and rd.status == tkt.Status.CONVERGED
    assert rd.certified_bound[-1] < 1e-8 and tuple(rd.x.factors.shape[:2]) == (2, 64)


def test_examples_refuse_without_a_card(monkeypatch):
    """Without --cpu an example runs on the card: with none it raises, naming
    the CPU option, before any solve."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        _main("01_basic_solve_torch.py")(["--d", "2", "--n", "8"])
