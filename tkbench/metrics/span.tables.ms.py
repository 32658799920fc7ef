"""span.tables.ms: host ms per profiled solve in the program's 'solve.tables'
span (coeffs/tables.load_tables in solve's set-up), unsynchronized; under the
profiler, an upper bound."""
from tkbench.program_spans import per_solve


def read(t):
    return per_solve(t, "solve.tables", "host")
