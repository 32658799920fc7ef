"""sharded.span.defl_finish.ms: span.defl_finish.ms in the four-card cell,
where it moves sharded_solve_s. The reader is span.defl_finish.ms's."""
from tkbench.harness import load_metric

_base = load_metric("span.defl_finish.ms")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
