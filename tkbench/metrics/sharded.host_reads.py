"""sharded.host_reads: host_reads in the four-card cell, where it moves
sharded_solve_s. The reader is host_reads's."""
from tkbench.harness import load_metric

_base = load_metric("host_reads")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
