"""df64.step_roofline: the recording step's share of its HBM roofline over the
profiled solves (storage='df64').

Bytes step k must move (df64_core._df64_step), at d factors of n, nb bands,
a deflation basis U of shape (u, n, m) (u = 1 when the factors share it)
and the stored basis V[:k], each held as f64 (the exact value of an f32
pair, 8 bytes an entry):
  - U read twice, once for the projection's coefficients and once for its
    lift: 2·8·u·n·m;
  - V[:k] read twice, once for the sweep's coefficients and once for its
    span: 2·8·d·n·k;
  - the pair SpMV's bands (f32 pairs) read once, 8·d·nb·n; the carried
    pairs v_{k-1} and v_{k-2} and the f64 b⊥ read once each, and v_k
    written once (the pair value stored as column k), 8·d·n·4.
At d=10, n=131072, m=2048, u=1, nb=3, k=192: 4.295 GB + 4.027 GB + 73.4 MB
= 8.395 GB, 2.51 ms at 3.35 TB/s. The expansion arithmetic's f32 triples
between these operations are the implementation's, not the algorithm's,
and are not counted. The bound is those bytes over HBM bandwidth; the share
is the bounds of the profiled solves' 'deflated.df64_step' spans summed,
step k being a solve's k-th step span, against those spans' device ms
summed (each span's timing events, its idle gaps included). The shapes are
recorded as each solve enters deflate._solve_df64. No reading off a CUDA
card."""
import numpy as np

from tkbench.program_spans import records

NAME = "df64_shapes"


def _shape(op, b, b_np, b_norm, basis, *args, **kwargs):
    return tuple(op.bands.shape), tuple(np.shape(basis.U))


RECORDS = [dict(name=NAME, module="tensorkrylov_tpu_torch.deflate", attr="_solve_df64", shape=_shape)]


def work(bands_shape, u_shape, k):
    """Bytes recording step k needs."""
    d, nb, n = bands_shape
    u, _, m = u_shape
    return 2 * 8 * u * n * m + 2 * 8 * d * n * k + 8 * d * n * (nb + 4)


def read(t):
    shapes = set(t.records.get(NAME, []))
    recs = records(t)
    if len(shapes) != 1 or not recs:
        return None
    (bands_shape, u_shape), = shapes
    bound = device_ms = 0.0
    for r in recs:
        steps = [s for s in r.spans if s.name == "deflated.df64_step"]
        for k, s in enumerate(steps, 1):
            if s.device_ms is None:
                return None
            bound += work(bands_shape, u_shape, k) / t.peaks["hbm_bytes_per_s"]
            device_ms += s.device_ms
    return 100.0 * bound / (device_ms / 1e3) if device_ms > 0 else None
