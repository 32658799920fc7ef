"""arnoldi.span.step.ms: span.step.ms in the Arnoldi cell (one CGS2 step,
ops/orth.arnoldi_step), where it moves solve_s. The reader is
span.step.ms's: device ms, mean per step."""
from tkbench.harness import load_metric

_base = load_metric("span.step.ms")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
