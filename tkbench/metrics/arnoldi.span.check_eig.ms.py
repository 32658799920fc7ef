"""arnoldi.span.check_eig.ms: host ms of the program's 'solve.check.eig' span
(ops/expsum.cp_solve_nonsym_eig: the complex eigendecomposition of the
padded Hessenbergs, S⁻¹b̃ and the term contraction), mean per check. On a
CUDA tensor torch.linalg.eig waits for the card, so the wall covers the
device work queued before it. Under the profiler, an upper bound."""
from tkbench.program_spans import mean


def read(t):
    return mean(t, "solve.check.eig", "host")
