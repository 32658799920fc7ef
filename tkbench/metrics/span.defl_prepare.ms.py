"""span.defl_prepare.ms: self host ms per profiled solve in the program's
'deflated.prepare' spans (solve_deflated from entry to its first step, less
the upload: checks, tables, Gershgorin bound, coefficients and their sup
error, host copies of the bands and b, the recurrence's state). Under the
profiler, an upper bound."""
from tkbench.program_spans import per_solve


def read(t):
    return per_solve(t, "deflated.prepare", "self")
