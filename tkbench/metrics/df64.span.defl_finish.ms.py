"""df64.span.defl_finish.ms: self host ms per profiled solve in the program's
'deflated.finish' span of a df64 solve (after the deciding checkpoint: the
assembly of x from U's pair, V and the coefficients, the drift, the
basis-free cross-check). Under the profiler, an upper bound."""
from tkbench.program_spans import per_solve


def read(t):
    return per_solve(t, "deflated.finish", "self")
