"""deflated.banded_spmv_roofline: banded_spmv_roofline in the deflated cells,
where it moves deflated_solve_s. The reader is banded_spmv_roofline's."""
from tkbench.harness import load_metric

_base = load_metric("banded_spmv_roofline")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
