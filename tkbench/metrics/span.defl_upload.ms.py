"""span.defl_upload.ms: device ms per profiled solve in the program's
'deflated.upload' span (the deflation basis U copied to the card from host
memory, and b's split c = Uᵀb, b⊥ = b − U c), from the span's timing
events."""
from tkbench.program_spans import per_solve


def read(t):
    return per_solve(t, "deflated.upload", "device")
