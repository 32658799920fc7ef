"""df64.device.idle_pct: device.idle_pct in the df64 cell, where it moves solve_s.
The reader is device.idle_pct's."""
from tkbench.harness import load_metric

_base = load_metric("device.idle_pct")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
