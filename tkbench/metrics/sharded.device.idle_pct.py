"""sharded.device.idle_pct: the mean over the cell's cards of each card's
100·(1 − busy / wall) over the profiled solves, busy being the union of that
card's own kernel, copy and set intervals and wall the profiled window (an
upper bound, as device.idle_pct is). Where one card works while the others
wait, as the lead does through a solve's preparation, checkpoints and
finish, this reads the waiting that device.idle_pct's union over the cards
hides."""
from tkbench.tracing import busy_and_gaps


def read(t):
    if not t.cards or t.window_ns is None or not t.device_events:
        return None
    wall = (t.window_ns[1] - t.window_ns[0]) / 1e9
    return sum(100.0 * (1.0 - busy_and_gaps(t, c)[0] / wall) for c in t.cards) / len(t.cards)
