"""One run of one benchmark cell: set-up, the measured window, the check.

Everything a cell is made of is found by name: the cell and its metrics in
``BENCHMARK.json``, the configuration in the file that entry names, the
traffic in ``tkbench/traffic/<traffic>.json``, each metric's reader in
``tkbench/metrics/<metric>.py`` and the configuration's plain reference in
``tkbench/reference/<operator family>.py``. Adding a cell, a configuration
or a metric adds files and edits none.

The program under test is ``tensorkrylov_tpu_torch``; this module imports it
only inside ``run``, on the device ``run`` is given (``run.py`` insists on a
CUDA card; the tests drive a tiny cell on the CPU).

A configuration may name a mesh, ``"mesh": {"cards": C, "factor_parallel":
F}``: the run then builds ``parallel.make_mesh`` over C cards from the lead
device on (C slots of the CPU in the tests) and passes it to the entry point
as ``mesh=``; the operator, the pool and the set-up objects stay on the lead
device, where the program expects them. A configuration with no mesh is one
card. Every card of the cell is synchronized around each solve and has its
peak memory read; the fullest card's is the cell's.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from tkbench import tracing, traffic as traffic_mod
from tkbench.reference.residual import relative_residual

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tensorkrylov_tpu")
CONVERGED = 1
PROFILED_S = 1.0

__all__ = ["load_spec", "cell", "mesh_cards", "metric_entries", "load_metric", "run", "judge", "forbidden_modules",
           "emit"]


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(spec: dict, name: str, root: Path, bench: Path = BENCH) -> dict:
    """The cell's workload entry, its configuration and traffic files, and
    its configuration's plain reference module."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg = _load_json(root / conf["file"])
    if w["chips"] != mesh_cards(cfg):
        raise ValueError(f"cell {name!r} asks for {w['chips']} chip(s), its configuration {w['config']!r} runs on "
                         f"{mesh_cards(cfg)} card(s)")
    family = cfg["operator"]["family"]
    return dict(workload=w, config=cfg, traffic=_load_json(bench / "traffic" / f"{w['traffic']}.json"),
                reference=_load_module(bench / "reference" / f"{family}.py", f"tkbench_reference_{family}"))


def mesh_cards(cfg: dict) -> int:
    """The cards a configuration runs on: its mesh's, or one."""
    return int(cfg.get("mesh", {}).get("cards", 1))


def metric_entries(spec: dict, name: str, traced: bool) -> list:
    """The metrics a run of cell `name` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = spec["per_layer" if traced else "end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def load_metric(name: str, bench: Path = BENCH):
    return _load_module(bench / "metrics" / f"{name}.py", "tkbench_metric_" + name.replace(".", "_"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _peaks(cards) -> list:
    """Each card's max_memory_allocated since its last reset (0 off CUDA)."""
    return [torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0 for dev in cards]


def _reset_peaks(cards):
    for dev in cards:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)


def _mesh(tkt, cfg: dict, device):
    """The configuration's mesh over cards device, device + 1, … (slots of
    one CPU device off CUDA), or None; and the distinct devices of the
    cell, the lead first."""
    if "mesh" not in cfg:
        return None, [device]
    cards, fp = mesh_cards(cfg), int(cfg["mesh"].get("factor_parallel", 1))
    if device.type == "cuda":
        devices = [torch.device("cuda", (device.index or 0) + i) for i in range(cards)]
    else:
        devices = [device] * cards
    mesh = tkt.parallel.make_mesh(n_devices=cards, factor_parallel=fp, devices=devices)
    return mesh, list(dict.fromkeys(devices))


def _solver_config(tkt, cfg: dict, traffic: dict):
    fields = dict(cfg["solver"], **traffic.get("solver", {}))
    for key in ("basis_dtype", "proj_dtype"):
        if key in fields:
            fields[key] = getattr(torch, fields[key])
    return tkt.SolverConfig(**fields)


def _claimed(res) -> float:
    """The residual the program claims for its answer: the certified bound of
    a deflated solve, the Lemma-3.4 estimate at the last check of a solve."""
    if hasattr(res, "certified_bound"):
        return float(res.certified_bound[-1])
    return float(res.relative_residual[res.niterations])


def judge(cfg: dict, reference, pool: torch.Tensor, samples: list, results: list, device) -> dict:
    """The numbers compared, each with its limit: the largest true relative
    residual ‖A x − b‖/‖b‖ of the checked answers, worked out by the
    reference from its own factors (limit: the configuration's tol), and the
    solves of the window whose status is not CONVERGED (limit 0)."""
    offsets, bands = reference.factor_bands(cfg["operator"], device)
    resid = [relative_residual(offsets, bands, s["weights"].to(device), s["factors"].to(device), pool[s["rhs"]])
             for s in samples]
    unconverged = sum(1 for r in results if r["status"] != CONVERGED)
    return {"resid_max": {"value": max(resid) if resid else math.inf, "limit": cfg["solver"]["tol"]},
            "unconverged": {"value": unconverged, "limit": 0},
            "checked": {"value": len(resid), "limit": 1}}


def _correct(checks: dict) -> bool:
    # written so that a NaN reading fails; 'checked' is a floor, the others ceilings
    return (checks["resid_max"]["value"] <= checks["resid_max"]["limit"]
            and checks["unconverged"]["value"] <= checks["unconverged"]["limit"]
            and checks["checked"]["value"] >= checks["checked"]["limit"])


def _log(*parts):
    print("tkbench:", *parts, file=sys.stderr, flush=True)


def _host_loop_ms(reps: int = 5) -> float:
    """The median milliseconds of a fixed pure-Python loop: the host's speed
    as the program's Python sees it, read after the window (the host-bound
    cells' solve times follow it)."""
    times = []
    for _ in range(reps):
        t0, acc = time.perf_counter(), 0
        for i in range(300_000):
            acc += i * i
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[reps // 2]


def run(spec: dict, name: str, seed: int, seconds: float, traced: bool, device, t_start: float,
        root: Path, bench: Path = BENCH) -> tuple:
    """Set up cell `name` from `seed`, measure it for `seconds`, check it.
    Returns (result dict without checks, checks dict)."""
    import tensorkrylov_tpu_torch as tkt

    c = cell(spec, name, root, bench)
    cfg, tr, ref = c["config"], c["traffic"], c["reference"]
    entries = metric_entries(spec, name, traced)
    readers = {m["name"]: load_metric(m["name"], bench) for m in entries}

    fn, args = ref.program_operator(cfg["operator"])
    op = getattr(tkt, fn)(**args, device=device)
    pool = traffic_mod.rhs_pool(tr["rhs"], op.d, op.n, seed, device)
    config = _solver_config(tkt, cfg, tr)
    kwargs = dict(cfg.get("call", {}), **tr.get("call", {}))
    for key, how in cfg.get("setup", {}).items():
        kwargs[key] = getattr(tkt, how["call"])(op, **how.get("args", {}))
    mesh, cards = _mesh(tkt, cfg, device)
    if mesh is not None:
        kwargs["mesh"] = mesh
    entry = getattr(tkt, cfg["entry"])
    sched = traffic_mod.Schedule(pool.shape[0], seed)
    _log(f"built in {time.perf_counter() - t_start:.3f} s since start")

    def solve(b):
        tracing.sync(cards)
        t0 = time.perf_counter()
        res = entry(op, b, config, **kwargs)
        tracing.sync(cards)
        return res, time.perf_counter() - t0

    warm = []
    for _ in range(int(tr["warmup_solves"])):
        res, wall = solve(pool[sched.next_rhs()])
        warm.append(wall)
        del res
    _log("warm solves (s):", *(f"{w:.4f}" for w in warm))
    # a traced run's checked solves come from its span solves (half the window)
    expected = int((seconds / 2 if traced else seconds) / max(warm[-1], 1e-3)) if warm else 1
    checked = sched.checked(expected, int(tr["check_sample"]))

    trace = tracing.Trace(_load_json(bench / "peaks.json"))
    if len(cards) > 1:
        trace.cards = [dev.index for dev in cards]
    samples = []
    setup_peaks = _peaks(cards)
    _reset_peaks(cards)

    def window(until):
        """Solves back to back until the deadline (at least one)."""
        done = 0
        while done == 0 or time.perf_counter() < until:
            pos = len(trace.results)
            i = sched.next_rhs()
            res, wall = solve(pool[i])
            trace.walls.append(wall)
            trace.results.append(dict(status=int(res.status), niterations=int(res.niterations)))
            if pos in checked:
                # the harness's own copy of a checked answer: timed, and left out of solve_s
                t_copy = time.perf_counter()
                samples.append(dict(rhs=i, weights=res.x.weights.cpu(), factors=res.x.factors.cpu(),
                                    claimed=_claimed(res)))
                trace.copy_s += time.perf_counter() - t_copy
            del res
            done += 1
        return done

    t_window = time.perf_counter()
    trace.setup_s = t_window - t_start
    if traced:
        span_specs = [s for r in readers.values() for s in getattr(r, "SPANS", [])]
        record_specs = [s for r in readers.values() for s in getattr(r, "RECORDS", [])]
        with tracing.spans(span_specs, trace, device):
            trace.span_solves = window(t_window + seconds / 2)
        with tracing.profiled(span_specs, record_specs, trace, device):
            # the profiler starts and ends in seconds and keeps every event:
            # a second of solves, at least one, is enough for the shares
            trace.profiled_solves = window(time.perf_counter() + PROFILED_S)
    else:
        window(t_window + seconds)
    window_s = trace.window_s = time.perf_counter() - t_window
    _log(f"host speed after the window: a fixed Python loop {_host_loop_ms():.2f} ms; "
         f"harness copies in the window {trace.copy_s:.3f} s")
    window_peaks = _peaks(cards)
    # the fullest card bounds the deployment
    trace.peak_bytes = max(window_peaks)
    w = sorted(trace.walls)
    _log(f"window {window_s:.3f} s, {len(w)} solves, setup {trace.setup_s:.3f} s; solve walls min "
         f"{w[0]:.4f} median {w[len(w) // 2]:.4f} max {w[-1]:.4f} s")

    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(trace)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    card_peaks = [max(s, w) for s, w in zip(setup_peaks, window_peaks)]
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": len(cards), "memory_peak_bytes": max(card_peaks)}
    result = {"correct": False, "attempted": len(trace.results),
              "failed": sum(1 for r in trace.results if r["status"] != CONVERGED),
              "metrics": metrics, "device": dev_info}
    if trace.cards:
        dev_info["cards"] = [{"device": str(dev), "memory_peak_bytes": p} for dev, p in zip(cards, card_peaks)]
    if traced:
        # busy time card by card on several cards (their mean; the lead's idle gaps), else the union
        per_card = [tracing.busy_and_gaps(trace, c) for c in trace.cards or [None]]
        for card, (card_busy, _) in zip(dev_info.get("cards", []), per_card):
            card["busy_s"] = card_busy
        w0, w1 = trace.window_ns or (0, 0)
        dev_info.update(busy_s=sum(b for b, _ in per_card) / len(per_card), window_s=(w1 - w0) / 1e9)
        result["breakdown"] = _breakdown(trace, per_card[0][1])

    # the program's state goes before the reference runs, so that the
    # reference neither meets it in memory nor sets the peak
    del op, kwargs, entry, mesh
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()        # every card's cached blocks
    t_check = time.perf_counter()
    checks = judge(cfg, ref, pool, samples, trace.results, device)
    _log(f"reference check of {len(samples)} answers: {time.perf_counter() - t_check:.3f} s")
    for s in samples:
        _log(f"checked rhs {s['rhs']}: claimed {s['claimed']:.6e}")
    result["correct"] = _correct(checks)
    return result, checks


def _breakdown(trace, gaps) -> dict:
    w0, w1 = trace.window_ns or (0, 0)
    ops = {}
    for name, s, e in trace.device_events:
        if e > w0 and s < w1:
            ops[name[:120]] = ops.get(name[:120], 0.0) + (e - s) / 1e9
    idle = {}
    for what, sec in gaps:
        idle[what[:120]] = idle.get(what[:120], 0.0) + sec
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines of standard error, then the result as the
    last line of standard output, the checks under the key that comes last."""
    for key, c in checks.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(dict(result, checks=checks)), flush=True)

