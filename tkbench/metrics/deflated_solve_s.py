"""deflated_solve_s: solve_s in the deflated cells, which complete about a
dozen solves a window; its own bound, set from their spreads. The reader is
solve_s's."""
from tkbench.harness import load_metric

_base = load_metric("solve_s")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
