"""arnoldi.host_reads: host_reads in the Arnoldi cell, where it moves solve_s.
The reader is host_reads's. On this path a check's count includes its
torch.linalg.eig, which waits for the card (utils/profiling.host_read)."""
from tkbench.harness import load_metric

_base = load_metric("host_reads")
read = _base.read
RECORDS = getattr(_base, "RECORDS", [])
