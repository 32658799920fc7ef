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

from tkbench import harness, tracing  # noqa: E402
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
                                         ("tiny.deflated_twopass", True), ("tiny.sharded_ring4", False),
                                         ("tiny.sharded_ring4", True)])
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
    # one CPU, whatever its slots: the result's device is as it was before meshes
    device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert result["device"] == (dict(device, busy_s=0.0, window_s=result["device"]["window_s"]) if traced else device)
    assert set(result["checks"]) == {"resid_max", "unconverged", "checked"}
    err = out.stderr.strip().splitlines()
    assert [line.split()[1] for line in err[-3:]] == list(result["checks"])
    reported = set(result["metrics"])
    if traced:
        if "sharded" in cell:       # every metric of the cell that does not read the device's trace
            assert reported == {"sharded.solver.iterations", "sharded.host_reads", "sharded.span.defl_prepare.ms",
                                "sharded.span.defl_upload.ms", "sharded.span.defl_step.ms",
                                "sharded.span.defl_evaluate.ms", "sharded.span.defl_finish.ms"}
        group = "" if cell == "tiny.solve" else "sharded." if "sharded" in cell else "deflated."
        assert group + "solver.iterations" in reported and ("defl_step.ms" in reported) == ("deflated" in cell)
        assert {"device_ops", "idle_gaps"} == set(result["breakdown"])
    elif "sharded" in cell:
        assert reported == {"sharded_solve_s", "setup_s"}        # no device memory on the CPU
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


@pytest.mark.parametrize("cell", ["tiny.solve", "tiny.deflated_full", "tiny.sharded_ring4"])
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

    spmv, spmv_sharded = krylov.spmv, krylov.spmv_sharded

    def half(op, v):
        out = spmv(op, v)
        out[op.d // 2:] = 0.0
        return out

    def half_pieces(sop, vs):
        out = spmv_sharded(sop, vs)
        for u in out:
            u[u.shape[0] // 2:] = 0.0
        return out
    monkeypatch.setattr(krylov, "spmv", half)
    monkeypatch.setattr(krylov, "spmv_sharded", half_pieces)


def _edges_not_exchanged(monkeypatch):
    """The SpMV's exchange between shards left out: every halo reads zeros."""
    from tensorkrylov_tpu_torch.parallel import halo

    exchange = halo.exchange_halos

    def none(sop, vs):
        halos, events = exchange(sop, vs)
        for lh, rh in halos:
            lh.zero_()
            rh.zero_()
        return halos, events
    monkeypatch.setattr(halo, "exchange_halos", none)


def _partials_not_exchanged(monkeypatch):
    """The dots' exchange between shards left out: the lead's partial alone."""
    from tensorkrylov_tpu_torch import deflate_light
    from tensorkrylov_tpu_torch.parallel import krylov

    psum = krylov.psum

    def lead_only(op, partials):
        if len(partials) > 1:
            partials = [partials[0]] + [torch.zeros_like(x) for x in partials[1:]]
        return psum(op, partials)
    monkeypatch.setattr(krylov, "psum", lead_only)
    monkeypatch.setattr(deflate_light, "psum", lead_only)


FAULTS = [pytest.param(_step_unchanged, id="step_returns_state_unchanged"),
          pytest.param(_answer_altered, id="answer_altered"),
          pytest.param(_half_the_factors, id="half_the_factors_left_out")]
CROSS = [pytest.param(_edges_not_exchanged, id="halo_exchange_left_out"),
         pytest.param(_partials_not_exchanged, id="partial_sums_exchange_left_out")]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", ["tiny.solve", "tiny.deflated_full", "tiny.sharded_ring4"])
def test_fault_makes_the_run_incorrect(tiny, monkeypatch, fault, cell):
    fault(monkeypatch)
    result, checks = _run(*tiny, cell)
    assert result["correct"] is False, checks


@pytest.mark.parametrize("fault", CROSS)
def test_an_exchange_between_cards_left_out_makes_the_run_incorrect(tiny, monkeypatch, fault):
    fault(monkeypatch)
    result, checks = _run(*tiny, "tiny.sharded_ring4")
    assert result["correct"] is False, checks


def _trace(events):
    """A profiled window of 0-100 ns with device events (name, start, end, card)."""
    t = tracing.Trace({})
    t.window_ns = (0, 100)
    for name, s, e, card in events:
        t.device_events.append((name, s, e))
        t.card_events[card].append((name, s, e))
    t.cards = sorted(t.card_events)
    return t


def test_busy_time_card_by_card():
    t = _trace([("k", 0, 40, 0), ("k", 30, 50, 0), ("k", 20, 60, 1), ("Memcpy PtoP (Device -> Device)", 90, 95, 1)])
    assert tracing.busy_and_gaps(t)[0] == pytest.approx(65e-9)          # the union over the cards
    assert [tracing.busy_and_gaps(t, c)[0] for c in t.cards] == pytest.approx([50e-9, 45e-9])
    assert [g for _, g in tracing.busy_and_gaps(t, 0)[1]] == pytest.approx([50e-9])
    idle = harness.load_metric("sharded.device.idle_pct").read(t)
    assert idle == pytest.approx(100 * (1 - (0.5 + 0.45) / 2))
    t.profiled_solves = 2
    assert harness.load_metric("sharded.peer_copy.ms_per_solve").read(t) == pytest.approx(5e-6 / 2)


def test_one_card_reads_as_before():
    """On one card the per-card reading is the union's, and the metrics that
    take every card read as they did."""
    t = _trace([("k", 0, 40, 0), ("k", 30, 50, 0), ("k", 70, 80, 0)])
    assert tracing.busy_and_gaps(t) == tracing.busy_and_gaps(t, 0)
    assert harness.load_metric("device.idle_pct").read(t) == pytest.approx(40.0)
    assert harness.load_metric("sharded.device.idle_pct").read(t) == pytest.approx(40.0)
    assert harness.load_metric("sharded.peer_copy.ms_per_solve").read(t) is None


def test_no_card_no_result():
    out = subprocess.run([sys.executable, str(REPO / "tkbench" / "run.py"), "--workload", "rd_kappa1e2.solve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    assert out.returncode == 2 and out.stdout == ""
