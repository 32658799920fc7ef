"""A copy of the benchmark with tiny cells of each configuration's family,
for CPU tests: the cells are added as files and BENCHMARK.json entries
only, as a later change would add them."""
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "tiny_rd_kappa1e2": dict(base="rd_d10_n131072_kappa1e2", d=3, n=48, kappa=1e2, solver=dict(kmax=60)),
    "tiny_rd_kappa1e4": dict(base="rd_d10_n131072_kappa1e6", d=3, n=64, kappa=1e4, solver=dict(kmax=48),
                             call=dict(checkpoints=[24, 32, 48]), setup=dict(basis=dict(call="deflation_basis",
                                                                                       args=dict(m=8)))),
    # four slots of the CPU in place of four cards, the ring route kept
    "tiny_rd_kappa1e4_ring4": dict(base="rd_d10_n131072_kappa1e6_ring4", d=3, n=64, kappa=1e4, solver=dict(kmax=48),
                                   call=dict(checkpoints=[24, 32, 48], comm="ring"),
                                   setup=dict(basis=dict(call="deflation_basis", args=dict(m=8)))),
}
# each tiny cell: its configuration, its traffic, and the full-size cell whose metrics it reports
CELLS = {"tiny.solve": ("tiny_rd_kappa1e2", "solve", "rd_kappa1e2.solve"),
         "tiny.solve_check8": ("tiny_rd_kappa1e2", "solve_check8", "rd_kappa1e2.solve_check8"),
         "tiny.deflated_full": ("tiny_rd_kappa1e4", "deflated_full", "rd_kappa1e6.deflated_full"),
         "tiny.deflated_twopass": ("tiny_rd_kappa1e4", "deflated_twopass", "rd_kappa1e6.deflated_twopass"),
         "tiny.sharded_ring4": ("tiny_rd_kappa1e4_ring4", "deflated_twopass", "rd_kappa1e6.sharded_ring4")}


def make(tmp: Path):
    """(spec, root, bench) of a checkout copy under tmp holding the tiny cells."""
    root = Path(tmp) / "checkout"
    bench = root / "tkbench"
    shutil.copytree(REPO / "tkbench", bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, t in TINY.items():
        cfg = json.loads((REPO / "tkbench" / "configs" / f"{t['base']}.json").read_text())
        cfg.update(name=name, operator=dict(cfg["operator"], d=t["d"], n=t["n"], kappa=t["kappa"]),
                   solver=dict(cfg["solver"], **t["solver"]))
        for key in ("call", "setup"):
            if key in t:
                cfg[key] = t[key]
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append(dict(name=name, source="https://doi.org/10.1137/090756843",
                                    file=f"tkbench/configs/{name}.json", reduced=["n"], why="CPU test size"))
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    for cell, (config, traffic, full) in CELLS.items():
        spec["workloads"].append(dict(name=cell, config=config, traffic=traffic, chips=chips[full],
                                      why="CPU test size"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if full in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return spec, root, bench
