"""The certifying north-star deployment on the CPU (storage='df64'): the
comparison that decides a run's `correct` on a tiny copy of its
configuration, the float32 control, the certificate's soundness against the
benchmark's plain reference (tkbench/reference/reaction_diffusion.py), the
spans and counted reads of a traced solve, and the recording step's
roofline count."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tkbench" / "tests"))

import tensorkrylov_tpu_torch as tkt  # noqa: E402
from tensorkrylov_tpu_torch.utils import profiling  # noqa: E402
from tkbench import control, harness  # noqa: E402
from tkbench.reference import residual  # noqa: E402
import tkbench_tiny  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
CELL = "tiny.deflated_df64"
D, N, KAPPA, M, CHECKPOINTS = 3, 64, 1e4, 8, [24, 32, 48]


def rhs(seed):
    g = torch.Generator().manual_seed(seed)
    b = torch.rand((D, N), generator=g, dtype=F64)
    return b / torch.linalg.vector_norm(b, dim=1, keepdim=True)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A checkout copy with the tiny cells and a tiny copy of the df64
    configuration, added as files and entries only: d=3, n=64, κ = 1e4,
    m = 8, checkpoints 24, 32, 48, reporting the df64 cell's metrics."""
    spec, root, bench = tkbench_tiny.make(tmp_path_factory.mktemp("tiny"))
    cfg = json.loads((REPO / "tkbench" / "configs" / "rd_d10_n131072_kappa1e6_df64.json").read_text())
    cfg.update(name="tiny_rd_df64", operator=dict(cfg["operator"], d=D, n=N, kappa=KAPPA),
               solver=dict(cfg["solver"], kmax=CHECKPOINTS[-1]), call=dict(cfg["call"], checkpoints=CHECKPOINTS),
               setup=dict(basis=dict(call="deflation_basis", args=dict(m=M))))
    (bench / "configs" / "tiny_rd_df64.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(name="tiny_rd_df64", source="https://doi.org/10.1137/090756843",
                                file="tkbench/configs/tiny_rd_df64.json", reduced=["n"], why="CPU test size"))
    spec["workloads"].append(dict(name=CELL, config="tiny_rd_df64", traffic="certified", chips=1,
                                  why="CPU test size"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "rd_kappa1e6.deflated_df64" in m.get("workloads", []):
            m["workloads"].append(CELL)
    return spec, root, bench


@pytest.fixture(scope="module")
def problem(tiny):
    """The tiny cell's operator, config, call and plain reference, built as
    harness.run builds them."""
    spec, root, bench = tiny
    c = harness.cell(spec, CELL, root, bench)
    cfg, tr, ref = c["config"], c["traffic"], c["reference"]
    fn, args = ref.program_operator(cfg["operator"])
    op = getattr(tkt, fn)(**args, device="cpu")
    config = harness._solver_config(tkt, cfg, tr)
    kwargs = dict(cfg["call"], **tr["call"])
    kwargs["basis"] = tkt.deflation_basis(op, m=M)
    assert kwargs["storage"] == "df64" and kwargs["final"] == "device"
    return cfg, ref, op, config, kwargs


@pytest.fixture(scope="module")
def answers(problem):
    """The port's df64 answers to two right-hand sides of the pool."""
    cfg, ref, op, config, kwargs = problem
    pool = torch.stack([rhs(s) for s in (1, 2)])
    return pool, [tkt.solve_deflated(op, pool[i], config, **kwargs) for i in range(2)]


def _faulty(kind, x):
    """The port's answer x with a planted fault."""
    w, X = x.weights.clone(), x.factors.clone()
    if kind == "half_terms":
        w[1::2] = 0.0
    elif kind == "float32":
        w, X = w.float(), X.float()
    return w, X


@pytest.mark.parametrize("kind", ["port", "half_terms", "float32"])
def test_judge_on_a_tiny_cell(problem, answers, kind):
    """The run's comparison on the port's df64 answers: correct, and not
    correct once half the exp-sum terms are dropped or once the answer is
    rounded to float32."""
    cfg, ref, *_ = problem
    pool, results = answers
    samples = []
    for i, res in enumerate(results):
        w, X = _faulty(kind, res.x)
        samples.append(dict(rhs=i, weights=w, factors=X, claimed=float(res.certified_bound[-1])))
    checks = harness.judge(cfg, ref, pool, samples, [dict(status=r.status) for r in results], CPU)
    assert checks["unconverged"]["value"] == 0 and checks["checked"]["value"] == 2
    assert harness._correct(checks) is (kind == "port"), checks


def test_the_float32_control_fails_the_tiny_cell(tiny):
    """The reference in float32 in the program's place does not pass."""
    spec, root, bench = tiny
    out = control.control(spec, CELL, 2 ** 31 + 25, torch.float32, CPU, root, bench)
    assert out["passes"] is False and out["checks"]["resid_max"]["value"] > 1e-8


def _full(x):
    """Σ_j w_j ⊗_s X[s, :, j] as an n^d vector."""
    w, X = x.weights.to(F64).numpy(), x.factors.to(F64).numpy()
    out = w[None, :]
    for s in range(X.shape[0]):
        out = (out[:, None, :] * X[s][None, :, :]).reshape(-1, X.shape[2])
    return out.sum(axis=1)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_the_certificate_bounds_the_true_residual(problem, seed):
    """Each df64 answer's certified bound is at least the reference's true
    ‖A x − b‖/‖b‖ of it, and x agrees with storage='full''s answer within
    the forward error both residuals allow: ‖x − x*‖/‖x*‖ ≤ κ(A)·r for an
    answer of true residual r, and κ(A) = κ for a sum of identical factors
    (its extreme eigenvalues are d times the factor's), so the two answers
    differ by at most κ·(r_df64 + r_full) relative to x* (≈ x_full)."""
    cfg, ref, op, config, kwargs = problem
    b = rhs(seed)
    offsets, bands = ref.factor_bands(cfg["operator"], CPU)
    res = tkt.solve_deflated(op, b, config, **kwargs)
    assert res.status == 1 and res.gram_source == "measured full Gram"
    true_df64 = residual.relative_residual(offsets, bands, res.x.weights, res.x.factors, b)
    assert true_df64 <= res.certified_bound[-1] < config.tol
    full_kwargs = {k: v for k, v in kwargs.items() if k not in ("storage", "final")}
    ful = tkt.solve_deflated(op, b, config, storage="full", **full_kwargs)
    true_full = residual.relative_residual(offsets, bands, ful.x.weights, ful.x.factors, b)
    x, x_full = _full(res.x), _full(ful.x)
    assert np.linalg.norm(x - x_full) <= KAPPA * (true_df64 + true_full) * np.linalg.norm(x_full)


def _traced(op, b, config, **kwargs):
    with profiling.tracing():
        res = tkt.solve_deflated(op, b, config, **kwargs)
    return res, profiling.solve_records()[-1]


# the reads a tiny df64 solve makes on the CPU, site by site (on the CPU every host_read of a CPU tensor counts)
READS = {
    # the bands and b to the host; λ_max's Gershgorin bands; the host sup error's ω and α; select_bh's table row
    # (digit, order, the row) and its rank
    "deflated.prepare": 2 + 1 + 2 + 4,
    # b⊥; the Gershgorin bands again; the bands for their rounding charge; b's split charge; the deflated
    # block's defect: the bands' rest, one equality test per factor after the first (identical factors, one
    # shared U), the norms; c; ω, α and the term mask
    "deflated.df64_init": 1 + 1 + 1 + 1 + (1 + (D - 1) + 1) + 1 + 3,
    "deflated.upload": 0,
    "deflated.df64_step": 0,
    # the leak and the overlap; with final='device' the cross-check's Gram pair and weights, with 'host'
    # V[:k] and the bands for the host cross-check
    "deflated.finish": {"device": 2 + 3, "host": 2 + 2},
}


def _evaluate_reads(gram):
    """W, C, dg, od, btil and dev to the host, the overlap and the leak for
    the cheap evaluation, and the measured Gram's max where it decides."""
    return 6 + 2 + int(gram)


@pytest.mark.parametrize("final", ["device", "host"])
def test_a_traced_solve_opens_each_df64_span_and_counts_its_reads(problem, final):
    """One 'deflated.df64_step' a step, one 'deflated.df64_evaluate' a
    checkpoint evaluated, one 'deflated.df64_init' and one
    'deflated.finish', each a child of the root 'deflated'; every span's
    host reads are the count of its sites, and the root's their sum plus
    the exp-sum rank read at the result."""
    cfg, ref, op, config, kwargs = problem
    res, rec = _traced(op, rhs(6), config, **dict(kwargs, final=final))
    assert res.status == 1 and res.niterations == CHECKPOINTS[-1]
    names = [s.name for s in rec.spans]
    assert names[:4] == ["deflated", "deflated.prepare", "deflated.upload", "deflated.df64_init"]
    assert names[-1] == "deflated.finish" and names.count("deflated.finish") == 1
    assert names.count("deflated.df64_init") == 1
    assert names.count("deflated.df64_step") == res.niterations
    evaluates = [s for s in rec.spans if s.name == "deflated.df64_evaluate"]
    assert len(evaluates) == len(res.checkpoints) == len(CHECKPOINTS)
    assert set(names) == {"deflated", "deflated.prepare", "deflated.upload", "deflated.df64_init",
                          "deflated.df64_step", "deflated.df64_evaluate", "deflated.finish"}
    assert all(s.parent is rec.root for s in rec.spans[1:])
    # the evaluations interleave with the steps: checkpoint ck's after step ck
    steps_before = [names[:names.index("deflated.df64_evaluate")].count("deflated.df64_step")]
    assert steps_before == [CHECKPOINTS[0]]

    got = {}
    for s in rec.spans[1:]:
        got.setdefault(s.name, []).append(s.host_reads)
    # the Fréchet evaluation with the measured Gram where the cheap bound nears tol (< 100·tol) and at the last
    gram = [b < 100 * config.tol or i == len(CHECKPOINTS) - 1 for i, b in enumerate(res.certified_bound)]
    assert gram == [False, True, True]
    assert got["deflated.df64_evaluate"] == [_evaluate_reads(g) for g in gram]
    assert got["deflated.df64_step"] == [0] * res.niterations
    for name in ("deflated.prepare", "deflated.df64_init", "deflated.upload"):
        assert got[name] == [READS[name]], name
    assert got["deflated.finish"] == [READS["deflated.finish"][final]]
    by_hand = (READS["deflated.prepare"] + READS["deflated.df64_init"] + sum(map(_evaluate_reads, gram))
               + READS["deflated.finish"][final] + 1)
    assert rec.root.host_reads == by_hand


def test_spans_change_no_bit():
    """A traced df64 solve returns the untraced one's numbers bit for bit."""
    op = tkt.laplace(2, 40, shift=30.0, device="cpu")
    b = torch.tensor(np.full((2, 40), 40 ** -0.5))
    cfg = tkt.SolverConfig(kmax=24, tol=1e-9)
    plain = tkt.solve_deflated(op, b, cfg, m=6, checkpoints=[12, 24], storage="df64", final="device")
    traced, _ = _traced(op, b, cfg, m=6, checkpoints=[12, 24], storage="df64", final="device")
    assert plain.certified_bound == traced.certified_bound
    assert plain.measured_cp_residual == traced.measured_cp_residual
    assert torch.equal(plain.x.factors, traced.x.factors) and torch.equal(plain.x.weights, traced.x.weights)


def test_step_roofline_counts_the_hand_numbers():
    """Step k = 192 at d=10, n=131072, m=2048, a shared U, 3 bands: U read
    twice, 2·8·131072·2048 = 4.295 GB; V[:192] read twice, 2·8·10·131072·192
    = 4.027 GB; the bands as pairs, v_{k-1}, v_{k-2}, b⊥ and v_k once,
    8·10·131072·(3 + 4) = 73.4 MB: 8.395 GB, 2.51 ms at 3.35 TB/s. Over
    steps 1..384 the U and V terms come to 3.20 TB."""
    m = harness.load_metric("df64.step_roofline")
    bands, U = (10, 3, 131072), (1, 131072, 2048)
    nbytes = m.work(bands, U, 192)
    assert nbytes == 4_294_967_296 + 4_026_531_840 + 73_400_320 == 8_394_899_456
    assert nbytes / 3.35e12 == pytest.approx(2.506e-3, rel=1e-3)
    vectors = 8 * 10 * 131072 * 7
    assert sum(m.work(bands, U, k) - vectors for k in range(1, 385)) == pytest.approx(3.1995e12, rel=1e-4)
    # a basis per factor reads d times U's bytes
    assert m.work(bands, (10, 131072, 2048), 1) - m.work(bands, U, 1) == 9 * 2 * 8 * 131072 * 2048


def test_step_roofline_reads_the_step_spans(monkeypatch):
    """The share: the bounds of each solve's steps, step k its k-th step
    span, against the spans' device time; none without one recorded shape
    or off the card (no device ms)."""
    m = harness.load_metric("df64.step_roofline")
    step = lambda ms: type("S", (), dict(name="deflated.df64_step", device_ms=ms))
    other = type("S", (), dict(name="deflated.df64_evaluate", device_ms=5.0))
    recs = [type("R", (), dict(spans=(step(1.0), step(2.0), other, step(3.0))))] * 2
    monkeypatch.setattr(m, "records", lambda t: recs)
    shape = ((10, 3, 131072), (1, 131072, 2048))
    t = type("T", (), dict(peaks={"hbm_bytes_per_s": 3.35e12}, records={m.NAME: [shape, shape]}))
    bound = 2 * sum(m.work(*shape, k) for k in (1, 2, 3)) / 3.35e12
    assert m.read(t) == pytest.approx(100 * bound / 12e-3)
    t.records = {m.NAME: [shape, ((10, 3, 131072), (10, 131072, 2048))]}
    assert m.read(t) is None
    t.records = {m.NAME: [shape]}
    monkeypatch.setattr(m, "records", lambda t: [type("R", (), dict(spans=(step(None),)))])
    assert m.read(t) is None


def test_step_roofline_records_the_solves_shapes():
    """The shape record reads the operator's bands and the basis's U from
    deflate._solve_df64's leading arguments."""
    m = harness.load_metric("df64.step_roofline")
    (spec,) = m.RECORDS
    assert spec["module"] == "tensorkrylov_tpu_torch.deflate" and spec["attr"] == "_solve_df64"
    op = tkt.reaction_diffusion(3, 32, 10.0, device="cpu")
    basis = tkt.deflation_basis(op, m=4)
    assert spec["shape"](op, None, None, 1.0, basis, "rest", x=1) == ((3, 3, 32), tuple(np.shape(basis.U)))
