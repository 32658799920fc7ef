"""df64.device.ops_per_solve: device.ops_per_solve in the df64 cell, where it moves solve_s.
The reader is device.ops_per_solve's."""
from tkbench.harness import load_metric

_base = load_metric("device.ops_per_solve")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
