"""The benchmark's files: BENCHMARK.json against the contract it is written
to, every file found by name, the roofline counts against the hand numbers,
and a cell added as files only."""
import json
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from tkbench import harness  # noqa: E402
import tkbench_tiny  # noqa: E402

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "tkbench/run.py"] and SPEC["paths"] == ["tkbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + METRICS]
                         + [w["traffic"] for w in SPEC["workloads"]]
                         + [k for c in SPEC["configs"] for k in c["reduced"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    work = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", work)) <= work
    if metric in SPEC["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    assert callable(harness.load_metric(metric["name"]).read)


def test_names_unique_and_every_cell_complete():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.metric_entries(SPEC, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metric_entries(SPEC, w["name"], True)
        assert 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_a_cell_asks_for_its_configurations_cards(w):
    cfg = json.loads((REPO / {c["name"]: c for c in SPEC["configs"]}[w["config"]]["file"]).read_text())
    assert w["chips"] in (1, 4) and w["chips"] == harness.mesh_cards(cfg)


def test_few_cells_ask_for_four_chips():
    four = [w["name"] for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4), four


def test_a_cell_whose_chips_differ_from_its_cards_is_refused():
    spec = json.loads(json.dumps(SPEC))
    w = next(w for w in spec["workloads"] if w["chips"] == 1)
    w["chips"] = 4
    with pytest.raises(ValueError, match="chip"):
        harness.cell(spec, w["name"], REPO)


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    c = harness.cell(SPEC, w["name"], REPO)
    assert c["config"]["name"] == w["config"]
    assert {"rhs", "solver", "call", "warmup_solves", "check_sample"} <= set(c["traffic"])
    assert callable(c["reference"].factor_bands) and callable(c["reference"].solve_config)


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"].startswith("tkbench/configs/")
    cfg = json.loads((REPO / conf["file"]).read_text())
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert cfg["solver"]["basis_dtype"] == cfg["solver"]["proj_dtype"] == "float64"
    assert conf["source"].startswith("https://") and len(conf["source"]) <= 200


def test_spmv_bytes_are_the_hand_numbers():
    spmv = harness.load_metric("banded_spmv_roofline")
    nbytes, ops = spmv.work((10, 3, 131072), (10, 131072), 8)
    assert nbytes == 52_428_800                         # 52.4 MB: bands, v and the output once
    assert nbytes / 3.35e12 == pytest.approx(1.565e-5, rel=1e-3)
    assert ops == 2 * 3 * 10 * 131072


def test_ring_spmv_bytes_are_the_hand_numbers():
    ring = harness.load_metric("ring_spmv_roofline")
    # one of four cards at d=10, n=131072: n_l = 32768, 3 bands, one vector, H = 1
    nbytes, ops = ring.work((10, 3, 32768), 1, 1, 2, 8)
    assert nbytes == 8 * (10 * 32768 * 5 + 2 * 10)       # 13.1 MB: bands, v, the output, two edge columns
    assert nbytes / 3.35e12 == pytest.approx(3.913e-6, rel=1e-3)
    assert ops == 2 * 3 * 10 * 32768 and ops / 3.4e13 < nbytes / 3.35e12
    assert ring.work((10, 3, 32768), 1, 1, 1, 8)[0] == nbytes - 8 * 10          # a chain end: one neighbour
    assert ring.work((10, 3, 32768), 4, 1, 2, 8) == (8 * (10 * 32768 * 11 + 2 * 40), 4 * ops)
    # four shards on one card, cap 8: one launch; ten shards: two launches
    one = ((10, 3, 32768), 1, 1, (1, 2, 2, 1), 8, 8)
    assert ring.launches(one) == [(4 * 8 * 10 * 32768 * 5 + 6 * 8 * 10, 4 * ops)]
    assert [n for n, _ in ring.launches(((10, 3, 32768), 1, 1, (2,) * 10, 8, 8))] == [8 * nbytes, 2 * nbytes]


def test_ring_spmv_share_pairs_launches_with_kernels():
    ring = harness.load_metric("ring_spmv_roofline")
    rec = ((10, 3, 32768), 1, 1, (1,), 8, 8)
    nbytes, _ = ring.work((10, 3, 32768), 1, 1, 1, 8)
    t = type("T", (), dict(peaks={"hbm_bytes_per_s": 3.35e12, "flop_per_s": {"float64": 3.4e13}},
                           records={"ring_spmv": [rec] * 4},
                           device_events=[("void ring_spmv_kernel<double>", 0, 10_000)] * 4
                           + [("banded_spmv_kernel", 0, 10_000)]))
    assert ring.read(t) == pytest.approx(100 * nbytes / 3.35e12 / 1e-5)
    t.device_events = t.device_events[1:]               # a launch the profiler did not see: no reading
    assert ring.read(t) is None


def test_eigh_bytes_are_the_hand_numbers():
    eigh = harness.load_metric("tridiag_eigh_roofline")
    nbytes, ops = eigh.work((10, 201, 201), 29, 8)
    assert nbytes == 8 * 10 * (57 + 201 + 201 * 201)    # 3.25 MB, Q written padded
    assert nbytes / 3.35e12 == pytest.approx(9.7e-7, rel=1e-2)
    assert ops / 3.4e13 < nbytes / 3.35e12


def test_solve_s_is_the_window_over_its_solves():
    t = type("T", (), dict(walls=[1.0, 2.0, 1.0, 2.0], window_s=7.5, copy_s=0.5))
    assert harness.load_metric("solve_s").read(t) == 1.75          # a gap between solves counts
    assert harness.load_metric("deflated_solve_s").read(t) == 1.75
    assert harness.load_metric("sharded_solve_s").read(t) == 1.75


OWN_READERS = {"sharded.device.idle_pct", "sharded.peer_copy.ms_per_solve"}     # the four-card cell's own


@pytest.mark.parametrize("name", [m["name"] for m in METRICS if m["name"].split(".")[0] in ("deflated", "sharded")
                                  and m["name"] not in OWN_READERS])
def test_a_deflated_copy_reads_as_its_base(name):
    """The deflated cells' and the four-card cell's copies read as the metric they copy."""
    base = harness.load_metric(name.split(".", 1)[1])
    copy = harness.load_metric(name)
    assert copy.read.__code__.co_filename == base.read.__code__.co_filename
    names = lambda m: [(r["name"], r["module"], r["attr"]) for r in getattr(m, "RECORDS", [])]
    assert names(copy) == names(base) and not getattr(copy, "SPANS", [])


def test_a_cell_added_as_files_is_found(tmp_path):
    spec, root, bench = tkbench_tiny.make(tmp_path)
    assert (bench / "configs" / "tiny_rd_kappa1e2.json").exists()
    c = harness.cell(spec, "tiny.solve", root, bench)
    assert c["config"]["operator"]["n"] == 48
    names = [m["name"] for m in harness.metric_entries(spec, "tiny.solve", False)]
    assert names == ["solve_s", "solve_p90_s", "peak_mem_gb", "setup_s"]
    traced = [m["name"] for m in harness.metric_entries(spec, "tiny.deflated_full", True)]
    assert "defl_step.ms" in traced and "projected_step.ms" not in traced


def test_a_metric_added_as_a_file_is_found(tmp_path):
    spec, root, bench = tkbench_tiny.make(tmp_path)
    (bench / "metrics" / "solve_min_s.py").write_text("def read(t):\n    return min(t.walls)\n")
    spec["end_to_end"].append(dict(name="solve_min_s", unit="s", better="lower", bound=0.05, source="host_clock"))
    assert "solve_min_s" in [m["name"] for m in harness.metric_entries(spec, "tiny.solve", False)]
    assert harness.load_metric("solve_min_s", bench).read(type("T", (), {"walls": [2.0, 1.0]})) == 1.0
