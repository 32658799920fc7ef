"""projected_step.ms: ms per call of solver.projected_step (eigh, exp-sum
coefficients, CP solve, Lemma-3.4 residual), synchronized, mean per call."""
SPANS = [dict(name="projected_step", module="tensorkrylov_tpu_torch.solver", attr="projected_step")]


def read(t):
    s = t.spans.get("projected_step")
    return 1e3 * sum(s) / len(s) if s else None
