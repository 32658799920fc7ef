"""df64.solver.iterations: solver.iterations in the df64 cell, where it moves solve_s.
The reader is solver.iterations's."""
from tkbench.harness import load_metric

_base = load_metric("solver.iterations")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
