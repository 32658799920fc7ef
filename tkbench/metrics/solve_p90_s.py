"""solve_p90_s: the 90th percentile of every solve's wall time in the window."""
import statistics


def read(t):
    if len(t.walls) < 10:
        return None
    return statistics.quantiles(t.walls, n=10, method="inclusive")[8]
