"""defl_step.ms: ms per deflated Lanczos step (deflate_light._step, pass 1 and
pass 2's replay alike), synchronized, mean per step."""
SPANS = [dict(name="defl_step", module="tensorkrylov_tpu_torch.deflate_light", attr="_step")]


def read(t):
    s = t.spans.get("defl_step")
    return 1e3 * sum(s) / len(s) if s else None
