"""arnoldi.span.check.ms: span.check.ms in the Arnoldi cell (one nonsymmetric
projected stage and its status read), where it moves solve_s. The reader is
span.check.ms's: host ms, mean per check."""
from tkbench.harness import load_metric

_base = load_metric("span.check.ms")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
