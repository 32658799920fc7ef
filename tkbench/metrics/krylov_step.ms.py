"""krylov_step.ms: ms per Krylov step of solve() (the callable that
solver._step_fn builds: ops/orth.lanczos_step), synchronized, mean per step."""
SPANS = [dict(name="krylov_step", module="tensorkrylov_tpu_torch.solver", attr="_step_fn", factory=True)]


def read(t):
    s = t.spans.get("krylov_step")
    return 1e3 * sum(s) / len(s) if s else None
