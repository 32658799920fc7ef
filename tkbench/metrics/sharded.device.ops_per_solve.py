"""sharded.device.ops_per_solve: device.ops_per_solve in the four-card cell,
where it moves sharded_solve_s. The reader is device.ops_per_solve's. It
counts every card's operations."""
from tkbench.harness import load_metric

_base = load_metric("device.ops_per_solve")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
