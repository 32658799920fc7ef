"""tridiag_eigh_roofline: the tridiagonal eigensolver kernel's share of
its roofline over the profiled solves.

Work of one call on the padded (d, K, K) projected matrices with k active
rows: bytes, the tridiagonal read once (2k − 1 values a factor) and the
outputs w (d, K) and Q (d, K, K) written once; operations, a lower bound on
bisection to the last bit, 52 halvings an eigenvalue each costing one
3-operation Sturm row of k entries (d·k·52·3k). The bound is the larger of
bytes over HBM bandwidth and operations over the f64 rate outside the tensor
cores; kernels matched by name, paired with the calls the wrapper saw."""
KERNEL = "tridiag_eigh_kernel"


def _shape(H, k, *args, **kwargs):
    return tuple(H.shape), int(k), H.element_size()


RECORDS = [dict(name="tridiag_eigh", module="tensorkrylov_tpu_torch.ops.eigen", attr="_tridiag_eigh_cuda",
                shape=_shape)]


def work(H_shape, k, itemsize):
    """(bytes, operations) one call needs."""
    d, K, _ = H_shape
    return itemsize * d * ((2 * k - 1) + K + K * K), d * k * 52 * 3 * k


def read(t):
    calls = t.records.get("tridiag_eigh", [])
    launches = [(s, e) for name, s, e in t.device_events if KERNEL in name]
    if not calls or len(calls) != len(launches):
        return None
    bound = 0.0
    for c in calls:
        nbytes, ops = work(*c)
        rate = t.peaks["flop_per_s"]["float64" if c[2] == 8 else "float32"]
        bound += max(nbytes / t.peaks["hbm_bytes_per_s"], ops / rate)
    return 100.0 * bound / (sum(e - s for s, e in launches) / 1e9)
