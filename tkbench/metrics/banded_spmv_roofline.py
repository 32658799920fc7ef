"""banded_spmv_roofline: the banded SpMV kernel's share of its roofline
over the profiled solves.

Work of one launch on bands (d, nb, n) and v (d, m, n) of itemsize bytes:
the bands, v and the output each moved once, 8·d·n·(nb + 2m) bytes in f64
(52.4 MB at d=10, n=131072, 3 bands, m=1), and 2·nb·d·m·n operations. The
bound is the larger of bytes over HBM bandwidth and operations over the f64
rate outside the tensor cores; the share is the bound summed over the
launches against their device time summed, the kernels matched by name in
the profiler and paired with the launches the wrapper saw."""
KERNEL = "banded_spmv_kernel"


def _shape(op, v):
    return tuple(op.bands.shape), tuple(v.shape), v.element_size()


RECORDS = [dict(name="banded_spmv", module="tensorkrylov_tpu_torch.ops.banded", attr="_spmv_cuda", shape=_shape)]


def work(bands_shape, v_shape, itemsize):
    """(bytes, operations) one launch needs."""
    d, nb, n = bands_shape
    m = 1 if len(v_shape) == 2 else v_shape[1]
    return itemsize * d * n * (nb + 2 * m), 2 * nb * d * m * n


def read(t):
    calls = t.records.get("banded_spmv", [])
    launches = [(s, e) for name, s, e in t.device_events if KERNEL in name]
    if not calls or len(calls) != len(launches):
        return None
    bound = 0.0
    for c in calls:
        nbytes, ops = work(*c)
        rate = t.peaks["flop_per_s"]["float64" if c[2] == 8 else "float32"]
        bound += max(nbytes / t.peaks["hbm_bytes_per_s"], ops / rate)
    return 100.0 * bound / (sum(e - s for s, e in launches) / 1e9)
