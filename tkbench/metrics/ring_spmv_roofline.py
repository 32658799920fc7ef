"""ring_spmv_roofline: the ring SpMV kernel's share of its roofline over the
profiled solves.

A RingLaunch call takes the shards of one card, up to the kernel's cap a
launch. Work of one shard with bands (d_f, nb, n_l) and v (d_f, [m,] n_l) of
itemsize bytes: the bands, v and the output each moved once, itemsize·d_f·
n_l·(nb + 2m) bytes, and the H edge columns of each neighbour it reads
(d_f·m·H values a side; none at a chain end); 2·nb·d_f·m·n_l operations. At
d=10, n=131072 over four cards (n_l = 32768, 3 bands, m=1) that is 13.1 MB
a shard. The bound of a launch is the larger of its shards' bytes over HBM
bandwidth and their operations over the f64 rate outside the tensor cores;
the share is the bound summed over the launches against their device time
summed, every card's kernels matched by name in the profiler and paired with
the launches the wrapper saw."""
KERNEL = "ring_spmv_kernel"


def _shape(launch, vs, lefts, rights):
    from tensorkrylov_tpu_torch.ops import _build

    v = vs[0]
    m = 1 if v.dim() == 2 else v.shape[1]
    sides = tuple((left is not None) + (right is not None) for left, right in zip(lefts, rights))
    return tuple(launch.shape), m, launch.H, sides, v.element_size(), int(_build.kernels().tk_ring_spmv_max_shards())


RECORDS = [dict(name="ring_spmv", module="tensorkrylov_tpu_torch.ops.ring_spmv", attr="RingLaunch.__call__",
                shape=_shape)]


def work(bands_shape, m, H, sides, itemsize):
    """(bytes, operations) of one shard that reads `sides` neighbours' edges."""
    d, nb, nl = bands_shape
    return itemsize * (d * nl * (nb + 2 * m) + sides * d * m * H), 2 * nb * d * m * nl


def launches(record):
    """The (bytes, operations) of each kernel launch of one recorded call."""
    shape, m, H, sides, itemsize, cap = record
    out = []
    for q0 in range(0, len(sides), cap):
        shards = [work(shape, m, H, s, itemsize) for s in sides[q0:q0 + cap]]
        out.append((sum(b for b, _ in shards), sum(o for _, o in shards)))
    return out


def read(t):
    work_ = [w for c in t.records.get("ring_spmv", []) for w in launches(c)]
    kernels = [(s, e) for name, s, e in t.device_events if KERNEL in name]
    if not work_ or len(work_) != len(kernels):
        return None
    itemsize = t.records["ring_spmv"][0][4]
    rate = t.peaks["flop_per_s"]["float64" if itemsize == 8 else "float32"]
    bound = sum(max(nbytes / t.peaks["hbm_bytes_per_s"], ops / rate) for nbytes, ops in work_)
    return 100.0 * bound / (sum(e - s for s, e in kernels) / 1e9)
