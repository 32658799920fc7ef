"""arnoldi.span.check_bendixson.ms: device ms of the program's
'solve.check.bendixson' span (the Bendixson bound: the dense eigh of the
Hessenbergs' symmetric part and the power-iteration norm sum), mean per
check, from the span's timing events, its idle gaps included."""
from tkbench.program_spans import mean


def read(t):
    return mean(t, "solve.check.bendixson", "device")
