"""span.check.ms: host ms of the program's 'solve.check' span (one projected
stage, solver.projected_step, and the status read that ends it), mean per
check; the read waits for the stage's device work, so the wall covers it.
Under the profiler, an upper bound."""
from tkbench.program_spans import mean


def read(t):
    return mean(t, "solve.check", "host")
