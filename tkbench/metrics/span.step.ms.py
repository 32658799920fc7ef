"""span.step.ms: device ms of the program's 'solve.step' span (one Krylov
step of solve: ops/orth.lanczos_step), mean per step, from the span's
timing events: the device's time from the step's first queued work to its
last, its idle gaps included."""
from tkbench.program_spans import mean


def read(t):
    return mean(t, "solve.step", "device")
