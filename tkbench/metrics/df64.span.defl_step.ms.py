"""df64.span.defl_step.ms: device ms of the program's 'deflated.df64_step'
span (one df64_core._df64_step: the pair SpMV, the recorded projection and
sweep, the commit), mean per step, from the span's timing events: its idle
gaps included."""
from tkbench.program_spans import mean


def read(t):
    return mean(t, "deflated.df64_step", "device")
