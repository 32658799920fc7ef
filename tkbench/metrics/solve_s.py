"""solve_s: the window's wall time over the solves it completed. Every solve
ends in a synchronize; the gaps between solves count, only the harness's
own copies of the checked answers are taken out."""


def read(t):
    if not t.walls or t.window_s is None:
        return None
    return (t.window_s - t.copy_s) / len(t.walls)
