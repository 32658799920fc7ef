"""sharded.span.defl_upload.ms: span.defl_upload.ms in the four-card cell,
where it moves sharded_solve_s. The reader is span.defl_upload.ms's."""
from tkbench.harness import load_metric

_base = load_metric("span.defl_upload.ms")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
