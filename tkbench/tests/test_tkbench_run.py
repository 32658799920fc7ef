"""A run of tiny cells on the CPU: the result line, the modules loaded, the
faults that the comparison has to catch, and run.py without a card."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from tkbench import harness  # noqa: E402
import tkbench_tiny  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345      # seeds past 32 signed bits

DRIVE = """
import sys, time
T0 = time.perf_counter()
sys.path[:0] = [{repo!r}, {tests!r}]
import torch
torch.set_num_threads(1)
from tkbench import harness
import tkbench_tiny
spec, root, bench = tkbench_tiny.make({tmp!r})
result, checks = harness.run(spec, {cell!r}, {seed}, 0.3, {traced}, torch.device("cpu"), T0, root, bench)
print("FORBIDDEN", harness.forbidden_modules())
harness.emit(result, checks)
"""


@pytest.mark.parametrize("cell,traced", [("tiny.solve", False), ("tiny.solve", True),
                                         ("tiny.deflated_twopass", True)])
def test_result_line_and_modules(tmp_path, cell, traced):
    code = DRIVE.format(repo=str(REPO), tests=str(Path(__file__).parent), tmp=str(tmp_path), cell=cell,
                        seed=SEED, traced=traced)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "FORBIDDEN []"
    result = json.loads(lines[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["checks"]) == {"resid_max", "unconverged", "checked"}
    err = out.stderr.strip().splitlines()
    assert [line.split()[1] for line in err[-3:]] == list(result["checks"])
    reported = set(result["metrics"])
    if traced:
        group = "deflated." if "deflated" in cell else ""
        assert group + "solver.iterations" in reported and ("defl_step.ms" in reported) == bool(group)
        assert {"device_ops", "idle_gaps"} == set(result["breakdown"])
    else:
        assert {"solve_s", "setup_s"} <= reported
        # the window's wall over its solves: solves times solve_s is the window, less the copies
        assert 0 < result["metrics"]["solve_s"]["value"] * result["attempted"] < 60


def _run(spec, root, bench, cell):
    result, checks = harness.run(spec, cell, SEED, 0.2, False, CPU, time.perf_counter(), root, bench)
    return result, checks


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tkbench_tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["tiny.solve", "tiny.deflated_full"])
def test_sound_run_is_correct(tiny, cell):
    result, checks = _run(*tiny, cell)
    assert result["correct"], checks


def _step_unchanged(monkeypatch):
    from tensorkrylov_tpu_torch import deflate_light, solver

    monkeypatch.setattr(solver, "_step_fn", lambda config: lambda op, st, b, k: (st, torch.zeros(())))
    monkeypatch.setattr(deflate_light, "_step", lambda op, st, *a, **k: st.vp)


def _answer_altered(monkeypatch):
    import tensorkrylov_tpu_torch as tkt

    for name in ("solve", "solve_deflated"):
        fn = getattr(tkt, name)

        def altered(*a, _fn=fn, **k):
            res = _fn(*a, **k)
            res.x.weights[0] *= 1.0 + 1e-4
            return res
        monkeypatch.setattr(tkt, name, altered)


def _half_the_factors(monkeypatch):
    from tensorkrylov_tpu_torch.parallel import krylov

    spmv = krylov.spmv

    def half(op, v):
        out = spmv(op, v)
        out[op.d // 2:] = 0.0
        return out
    monkeypatch.setattr(krylov, "spmv", half)


@pytest.mark.parametrize("fault", [_step_unchanged, _answer_altered, _half_the_factors],
                         ids=["step_returns_state_unchanged", "answer_altered", "half_the_factors_left_out"])
@pytest.mark.parametrize("cell", ["tiny.solve", "tiny.deflated_full"])
def test_fault_makes_the_run_incorrect(tiny, monkeypatch, fault, cell):
    fault(monkeypatch)
    result, checks = _run(*tiny, cell)
    assert result["correct"] is False, checks


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(REPO / "tkbench" / "run.py"), "--workload", "rd_kappa1e2.solve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert out.returncode == 2 and out.stdout == ""
