"""Run one cell of the benchmark of tensorkrylov_tpu_torch once, on a CUDA card.

From the root of a checkout:

  python3 tkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in BENCHMARK.json. --trace 0 reports the cell's
end-to-end metrics, --trace 1 its per-layer metrics (synchronized spans,
then the profiler). The last line of standard output is one JSON object
(correct, attempted, failed, metrics, device, [breakdown], checks); the
checks, each number compared beside its limit, are also the last lines of
standard error. Without a CUDA card, or with fewer cards than the cell asks
for, it exits with code 2 and prints no result; if JAX or the JAX package
was loaded, with code 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # caches of the program and of its libraries stay inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))

    import torch
    from tkbench import harness

    spec = harness.load_spec(ROOT)
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(args.workload)
    if chips is None:
        print(f"tkbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"tkbench: the cell needs {chips} CUDA card(s), this machine has {count}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, checks = harness.run(spec, args.workload, args.seed, args.seconds, bool(args.trace), device,
                                 T_START, ROOT)
    bad = harness.forbidden_modules()
    if bad:
        print(f"tkbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
