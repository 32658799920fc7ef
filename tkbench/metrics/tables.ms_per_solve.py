"""tables.ms_per_solve: ms in coeffs/tables.load_tables (as solver.py calls
it, once in each solve's set-up), synchronized, per span solve."""
SPANS = [dict(name="load_tables", module="tensorkrylov_tpu_torch.solver", attr="load_tables")]


def read(t):
    if not t.span_solves or not t.spans.get("load_tables"):
        return None
    return 1e3 * sum(t.spans["load_tables"]) / t.span_solves
