"""span.defl_step.ms: device ms of the program's 'deflated.step' span (one
deflate_light._step, pass 1 and pass 2's replay alike), mean per step, from
the span's timing events: its idle gaps included."""
from tkbench.program_spans import mean


def read(t):
    return mean(t, "deflated.step", "device")
