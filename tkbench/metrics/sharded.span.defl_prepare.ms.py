"""sharded.span.defl_prepare.ms: span.defl_prepare.ms in the four-card cell,
where it moves sharded_solve_s. The reader is span.defl_prepare.ms's."""
from tkbench.harness import load_metric

_base = load_metric("span.defl_prepare.ms")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
