"""solver.iterations: Krylov steps per solve, the mean over every solve of the
window (niterations of each result)."""


def read(t):
    if not t.results:
        return None
    return sum(r["niterations"] for r in t.results) / len(t.results)
