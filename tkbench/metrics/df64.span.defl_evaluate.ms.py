"""df64.span.defl_evaluate.ms: host ms per profiled solve in the program's
'deflated.df64_evaluate' spans (one a checkpoint evaluated: the host copies
of the record W, C, dg, od, btil and dev, the GEMMs' rounding charge, the
recorded relation's cheap evaluation and, where it decides, the Fréchet one
with the basis Gram measured on the card), summed over the solve's
checkpoints. Under the profiler, an upper bound."""
from tkbench.program_spans import per_solve


def read(t):
    return per_solve(t, "deflated.df64_evaluate", "host")
