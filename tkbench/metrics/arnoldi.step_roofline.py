"""arnoldi.step_roofline: the Arnoldi step's share of its roofline over the
profiled solves.

Bytes step k must move, for a basis of itemsize bytes and bands (d, nb, n):
the basis prefix V[:k] read four times by CGS2 (two projections, two
subtractions), and the SpMV's bands, input and output once each,
itemsize·d·n·(4k + nb + 2): 6.77 GB at d=10, n=131072, k=160, 4 bands, f64.
The bound is those bytes over HBM bandwidth. The share is the bounds of the
profiled solves' 'solve.step' spans summed, step k being a solve's k-th
step span, against those spans' device ms summed (each span's timing
events, its idle gaps included). The count is the algorithm's, whatever
implements the step; the operator's bands and the basis dtype are recorded
as each solve sets up (solver._setup). No reading off a CUDA card."""
from tkbench.program_spans import records

NAME = "arnoldi_setup"


def _shape(op, b, config, tables):
    return tuple(op.bands.shape), config.basis_dtype.itemsize


RECORDS = [dict(name=NAME, module="tensorkrylov_tpu_torch.solver", attr="_setup", shape=_shape)]


def work(bands_shape, k, itemsize):
    """Bytes Arnoldi step k needs."""
    d, nb, n = bands_shape
    return itemsize * d * n * (4 * k + nb + 2)


def read(t):
    shapes = set(t.records.get(NAME, []))
    recs = records(t)
    if len(shapes) != 1 or not recs:
        return None
    (bands_shape, itemsize), = shapes
    bound = device_ms = 0.0
    for r in recs:
        steps = [s for s in r.spans if s.name == "solve.step"]
        for k, s in enumerate(steps, 1):
            if s.device_ms is None:
                return None
            bound += work(bands_shape, k, itemsize) / t.peaks["hbm_bytes_per_s"]
            device_ms += s.device_ms
    return 100.0 * bound / (device_ms / 1e3) if device_ms > 0 else None
