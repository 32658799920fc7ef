"""host_reads: reads of device values into Python per profiled solve, the
program's own count (utils/profiling.host_read: each bool, int, float, .cpu,
.item or .tolist of a tensor on the solve's device, the root span's
host_reads). On the card each is a wait for the launch queue to drain."""
from tkbench.program_spans import records


def read(t):
    recs = records(t)
    return sum(r.root.host_reads for r in recs) / len(recs) if recs else None
