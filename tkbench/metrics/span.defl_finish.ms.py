"""span.defl_finish.ms: self host ms per profiled solve in the program's
'deflated.finish' span (after the last checkpoint: the assembly of x or
pass 2, its replayed steps left out as spans of their own, the drift, the
cross-check). Under the profiler, an upper bound."""
from tkbench.program_spans import per_solve


def read(t):
    return per_solve(t, "deflated.finish", "self")
