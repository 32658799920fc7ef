"""span.defl_evaluate.ms: host ms of the program's 'deflated.evaluate' span
(one checkpoint: deflate._evaluate and its certified bound, whose reads wait
for its device work), mean per checkpoint. Under the profiler, an upper
bound."""
from tkbench.program_spans import mean


def read(t):
    return mean(t, "deflated.evaluate", "host")
