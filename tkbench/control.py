"""The control of a cell's comparison: the plain reference put in the program's
place, in the precision below the configuration's (float32 for float64).

From the root of a checkout, on a CUDA card (or --cpu):

  python3 tkbench/control.py --workload <name> --seeds 11 12 13 [--dtype float32]

For each seed it makes the cell's right-hand-side pool as a run does, solves
as many of them as a run checks with the reference solver in --dtype, and
judges those answers with the run's own comparison. It prints one JSON line
per seed with each number compared and whether the answers pass (the
control has to fail). The benchmark's runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(spec: dict, name: str, seed: int, dtype, device, root: Path = ROOT, bench: Path = None) -> dict:
    """The checks of cell `name`'s comparison on the reference's answers in dtype."""
    from tkbench import harness, traffic

    c = harness.cell(spec, name, root, bench or harness.BENCH)
    cfg, tr, ref = c["config"], c["traffic"], c["reference"]
    d, n = int(cfg["operator"]["d"]), int(cfg["operator"]["n"])
    pool = traffic.rhs_pool(tr["rhs"], d, n, seed, device)
    sched = traffic.Schedule(pool.shape[0], seed)
    samples = []
    for _ in range(int(tr["check_sample"])):
        i = sched.next_rhs()
        w, X = ref.solve_config(cfg["operator"], pool[i], dtype)
        samples.append(dict(rhs=i, weights=w, factors=X, claimed=float("nan")))
    results = [dict(status=harness.CONVERGED, niterations=0)] * len(samples)
    checks = harness.judge(cfg, ref, pool, samples, results, device)
    return dict(checks=checks, passes=harness._correct(checks))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    from tkbench import harness

    if not args.cpu and not torch.cuda.is_available():
        print("control: no CUDA card (pass --cpu to run on the host)", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    spec = harness.load_spec(ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(spec, args.workload, seed, getattr(torch, args.dtype), device)
        print(json.dumps(dict(workload=args.workload, seed=seed, dtype=args.dtype,
                              seconds=time.perf_counter() - t0, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
