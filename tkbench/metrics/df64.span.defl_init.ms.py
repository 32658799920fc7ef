"""df64.span.defl_init.ms: self host ms per profiled solve in the program's
'deflated.df64_init' span (storage='df64', from the end of the upload to
the first step: U's f32-pair value, b's split charge, the recurrence's
start, the bands' rounding and pair split, the measured EFT epsilon, the
deflated block's defect A Ũ − Ũ Λ). Under the profiler, an upper bound."""
from tkbench.program_spans import per_solve


def read(t):
    return per_solve(t, "deflated.df64_init", "self")
