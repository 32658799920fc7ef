"""sharded.span.defl_step.ms: span.defl_step.ms in the four-card cell, where it
moves sharded_solve_s. The reader is span.defl_step.ms's. Its device ms are
the lead card's stream, where the span's root opens."""
from tkbench.harness import load_metric

_base = load_metric("span.defl_step.ms")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
