"""sharded.solver.iterations: solver.iterations in the four-card cell, where it
moves sharded_solve_s. The reader is solver.iterations's."""
from tkbench.harness import load_metric

_base = load_metric("solver.iterations")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
