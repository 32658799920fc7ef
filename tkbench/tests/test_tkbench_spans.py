"""The metrics that read the program's own spans and host-read counter
(tkbench/program_spans.py): a traced tiny cell of each kind reports every
per-layer metric of its full-size cell, the idle gaps of a deflated solve
are put down to its spans, and on the card every host read the program
counts is one synchronizing call."""
import collections
import sys
import time
import traceback
import warnings
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from tkbench import harness, tracing, traffic as traffic_mod  # noqa: E402
import tkbench_tiny  # noqa: E402

torch.set_num_threads(1)
SEED = 2 ** 31 + 4242
DEVICES = [pytest.param("cpu", id="cpu"), pytest.param("cuda", id="cuda", marks=pytest.mark.cuda)]
NEW = {"host_reads", "deflated.host_reads", "span.tables.ms", "span.step.ms", "span.check.ms",
       "span.defl_prepare.ms", "span.defl_upload.ms", "span.defl_step.ms", "span.defl_evaluate.ms",
       "span.defl_finish.ms", "sharded.host_reads", "sharded.span.defl_prepare.ms", "sharded.span.defl_upload.ms",
       "sharded.span.defl_step.ms", "sharded.span.defl_evaluate.ms", "sharded.span.defl_finish.ms"}


def _device(name, spec=None, cell=None):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if name == "cuda" and cell is not None:
        cards = next(w["chips"] for w in spec["workloads"] if w["name"] == cell)
        if torch.cuda.device_count() < cards:
            pytest.skip(f"needs {cards} CUDA devices")
    return torch.device(name, 0) if name == "cuda" else torch.device(name)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tkbench_tiny.make(tmp_path_factory.mktemp("tiny"))


def test_the_new_metrics_are_in_the_benchmark():
    spec = harness.load_spec(REPO)
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    assert NEW <= set(per_layer)
    for name in NEW:
        cells = per_layer[name]["workloads"]
        assert all(c.startswith("rd_kappa1e6." if "defl" in name or "sharded" in name else "rd_kappa1e2.")
                   for c in cells)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("cell", sorted(tkbench_tiny.CELLS))
def test_a_traced_tiny_cell_reports_every_per_layer_metric(tiny, cell, device):
    spec, root, bench = tiny
    dev = _device(device, spec, cell)
    result, checks = harness.run(spec, cell, SEED, 0.3, True, dev, time.perf_counter(), root, bench)
    assert result["correct"], checks
    full = tkbench_tiny.CELLS[cell][2]
    want = [m for m in spec["per_layer"] if full in m["workloads"]]
    if dev.type == "cpu":       # no device trace on the CPU: its readers report nothing there
        want = [m for m in want if m["source"] != "device_trace"]
    assert {m["name"] for m in want} <= set(result["metrics"])
    assert NEW & {m["name"] for m in want}
    for name in NEW & set(result["metrics"]):
        assert result["metrics"][name]["value"] > 0, name
    if dev.type == "cuda" and "deflated" in cell:
        gaps = dict(result["breakdown"]["idle_gaps"])
        assert any(k.startswith("deflated") for k in gaps), gaps


def _problem(spec, root, bench, cell, device):
    """The cell's operator, one right-hand side, its config and call, built
    as harness.run builds them."""
    import tensorkrylov_tpu_torch as tkt

    c = harness.cell(spec, cell, root, bench)
    cfg, tr, ref = c["config"], c["traffic"], c["reference"]
    fn, args = ref.program_operator(cfg["operator"])
    op = getattr(tkt, fn)(**args, device=device)
    b = traffic_mod.rhs_pool(tr["rhs"], op.d, op.n, SEED, device)[0]
    kwargs = dict(cfg.get("call", {}), **tr.get("call", {}))
    for key, how in cfg.get("setup", {}).items():
        kwargs[key] = getattr(tkt, how["call"])(op, **how.get("args", {}))
    mesh, _ = harness._mesh(tkt, cfg, device)
    if mesh is not None:
        kwargs["mesh"] = mesh
    return getattr(tkt, cfg["entry"]), op, b, harness._solver_config(tkt, cfg, tr), kwargs


@pytest.mark.parametrize("cell", ["tiny.deflated_full", "tiny.deflated_twopass"])
def test_idle_gaps_of_a_deflated_solve_name_its_spans(tiny, cell):
    """On the CPU the operators run on the host: taken as the device's work,
    the gaps between them are the program's Python, and every gap inside the
    solve is put down to a 'deflated' span."""
    entry, op, b, config, kwargs = _problem(*tiny, cell, torch.device("cpu"))
    trace = tracing.Trace({})
    with tracing.profiled([], [], trace, torch.device("cpu")):
        entry(op, b, config, **kwargs)
    trace.device_events = [e for e in trace.host_events if e[0].startswith("aten::")]
    _, gaps = tracing.busy_and_gaps(trace)
    by_span = collections.Counter()
    for what, sec in gaps:
        by_span[what.split("/")[0] if "/" in what else "python"] += sec
    named = sum(sec for what, sec in by_span.items() if what.startswith("deflated"))
    assert {"deflated.prepare", "deflated.evaluate", "deflated.finish"} <= set(by_span)
    assert named > 0.9 * sum(by_span.values()), by_span


def _in_host_read(stack) -> bool:
    return any(f.name == "host_read" and f.filename.endswith("profiling.py") for f in stack)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(tkbench_tiny.CELLS))
def test_on_the_card_every_counted_read_is_a_synchronizing_call(tiny, cell):
    """One warm solve under torch.cuda.set_sync_debug_mode(1): the
    synchronizing calls made inside utils/profiling.host_read are as many as
    the solve's host_reads; the others (pageable uploads and the like) are
    printed by site. In a solve() cell the others are only the tables'
    uploads."""
    from tensorkrylov_tpu_torch.utils import profiling

    dev = _device("cuda", tiny[0], cell)
    entry, op, b, config, kwargs = _problem(*tiny, cell, dev)
    entry(op, b, config, **kwargs)
    torch.cuda.synchronize(dev)
    syncs = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" in str(message):
            syncs.append(traceback.extract_stack()[:-1])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode(1)
        try:
            with profiling.tracing():
                entry(op, b, config, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    rec = profiling.solve_records()[-1]
    counted = [s for s in syncs if _in_host_read(s)]
    sites = [next((f for f in reversed(s) if "tensorkrylov_tpu_torch" in f.filename), None) for s in syncs
             if not _in_host_read(s)]
    others = collections.Counter(f"{Path(f.filename).name}:{f.lineno}" if f else "?" for f in sites)
    print(f"{cell}: host_reads {rec.root.host_reads}, synchronizing calls {len(syncs)}, in host_read "
          f"{len(counted)}, elsewhere {dict(others)}")
    assert len(counted) == rec.root.host_reads
    if rec.root.name == "solve":
        assert {f.name if f else "?" for f in sites} == {"load_tables"}, dict(others)
