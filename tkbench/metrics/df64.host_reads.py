"""df64.host_reads: host_reads in the df64 cell, where it moves solve_s.
The reader is host_reads's."""
from tkbench.harness import load_metric

_base = load_metric("host_reads")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
