"""sharded.peer_copy.ms_per_solve: device ms of the profiler's peer-to-peer
copies between cards ('Memcpy PtoP'), every card's summed, per profiled
solve: U's and b-perp's pieces sent to the cards on each call, the per-step
partial sums sent to the lead card, and x's gather. The ring kernel's reads
of its neighbours' edge columns go through peer access inside the kernel and
are not copies. On a mesh of one process the program's own comm_stats count
nothing (only traffic across processes), so the trace is read."""
KIND = "PtoP"


def read(t):
    if not t.profiled_solves or t.window_ns is None:
        return None
    w0, w1 = t.window_ns
    copies = [(s, e) for name, s, e in t.device_events if KIND in name and e > w0 and s < w1]
    return sum(e - s for s, e in copies) / 1e6 / t.profiled_solves if copies else None
