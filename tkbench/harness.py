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

__all__ = ["load_spec", "cell", "metric_entries", "load_metric", "run", "judge", "forbidden_modules", "emit"]


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
    family = cfg["operator"]["family"]
    return dict(workload=w, config=cfg, traffic=_load_json(bench / "traffic" / f"{w['traffic']}.json"),
                reference=_load_module(bench / "reference" / f"{family}.py", f"tkbench_reference_{family}"))


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


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    entry = getattr(tkt, cfg["entry"])
    sched = traffic_mod.Schedule(pool.shape[0], seed)
    _log(f"built in {time.perf_counter() - t_start:.3f} s since start")

    def solve(b):
        _sync(device)
        t0 = time.perf_counter()
        res = entry(op, b, config, **kwargs)
        _sync(device)
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
    samples = []
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

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
    trace.peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    w = sorted(trace.walls)
    _log(f"window {window_s:.3f} s, {len(w)} solves, setup {trace.setup_s:.3f} s; solve walls min "
         f"{w[0]:.4f} median {w[len(w) // 2]:.4f} max {w[-1]:.4f} s")

    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(trace)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": max(setup_peak, trace.peak_bytes)}
    result = {"correct": False, "attempted": len(trace.results),
              "failed": sum(1 for r in trace.results if r["status"] != CONVERGED),
              "metrics": metrics, "device": dev_info}
    if traced:
        busy, gaps = tracing.busy_and_gaps(trace)
        w0, w1 = trace.window_ns or (0, 0)
        dev_info.update(busy_s=busy, window_s=(w1 - w0) / 1e9)
        result["breakdown"] = _breakdown(trace, gaps)

    # the program's state goes before the reference runs, so that the
    # reference neither meets it in memory nor sets the peak
    del op, kwargs, entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
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

