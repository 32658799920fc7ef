"""The convection–diffusion deployment on the CPU: the benchmark's plain
reference (tkbench/reference/conv_diff.py) against the exact solution, the
port's Arnoldi solve against both, the comparison that decides a run's
`correct` on a tiny cell of the family, the nonsymmetric projected stage's
spans, and the Arnoldi step's roofline count."""
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
from tkbench.reference import conv_diff as cd, residual  # noqa: E402
import tkbench_tiny  # noqa: E402

# the batched complex solves of the reference and of the projected stage:
# one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64


def rhs(d, n, seed):
    g = torch.Generator().manual_seed(seed)
    b = torch.rand((d, n), generator=g, dtype=F64)
    return b / torch.linalg.vector_norm(b, dim=1, keepdim=True)


def dense_factor(n, c, sigma):
    """A_s from the bands, as a dense (n, n) array."""
    B = cd.bands(1, n, c, sigma)[0].numpy()
    A = np.zeros((n, n))
    for row, off in zip(B, cd.OFFSETS):
        i = np.arange(max(0, -off), min(n, n - off))
        A[i, i + off] = row[i]
    return A


def exact(d, n, c, sigma, b):
    """A⁻¹ b as an n^d vector, from the eigendecomposition of the one factor
    all d modes share: x = (⊗S) diag(1/Σ_s λ_{i_s}) (⊗S⁻¹) b."""
    lam, S = np.linalg.eig(dense_factor(n, c, sigma))
    coef = [np.linalg.solve(S, bs) for bs in b.numpy()]
    T, L = coef[0], lam
    for s in range(1, d):
        T = np.multiply.outer(T, coef[s])
        L = np.add.outer(L, lam)
    T = T / L
    for s in range(d):
        T = np.moveaxis(np.tensordot(S, T, axes=([1], [s])), 0, s)
    return np.real(T).reshape(-1)


def full(weights, factors):
    """Σ_j w_j ⊗_s X[s, :, j] as an n^d vector."""
    w, X = weights.to(F64).numpy(), factors.to(F64).numpy()
    out = w[None, :]
    for s in range(X.shape[0]):
        out = (out[:, None, :] * X[s][None, :, :]).reshape(-1, X.shape[2])
    return out.sum(axis=1)


def rel_err(x, ref):
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def test_bands_are_the_gallery_operator():
    """The reference's bands are the program's conv_diff (written apart, so
    they agree to rounding), zero outside the matrix."""
    n, c, sigma = 20, 10.0, cd.sigma_for_kappa(20, 1e3)
    B = cd.bands(3, n, c, sigma)
    op = tkt.conv_diff(3, n, c=c, shift=sigma, device="cpu")
    assert op.offsets == cd.OFFSETS and not op.symmetric
    torch.testing.assert_close(B, op.bands, rtol=1e-14, atol=0.0)
    assert B[:, 0, 0].eq(0).all() and B[:, 2, -1].eq(0).all() and B[:, 3, -2:].eq(0).all()


@pytest.mark.parametrize("c,kappa", [(10.0, 1e2), (10.0, 1e3)])
def test_reference_matches_the_exact_solution(c, kappa):
    """d=3, n=32 (32,768 unknowns). The reference stops at a true residual of
    at most TARGET = 1e-9; the forward error is at most κ₂(A) times that, and
    κ₂(A) ≤ ~κ for these near-normal factors: 1e-9·κ·10 leaves a decade for
    the eigenvector matrix's condition."""
    d, n = 3, 32
    sigma = cd.sigma_for_kappa(n, kappa)
    b = rhs(d, n, 11)
    w, X = cd.solve(d, n, c, sigma, b)
    assert w.dtype == X.dtype == F64 and X.shape == (d, n, w.numel())
    assert residual.relative_residual(cd.OFFSETS, cd.bands(d, n, c, sigma), w, X, b) <= cd.TARGET
    assert rel_err(full(w, X), exact(d, n, c, sigma, b)) <= 10 * cd.TARGET * kappa


CASES = [(3, 32, 10.0, 1e2), (2, 128, 10.0, 1e3), (4, 12, 5.0, 1e2)]


@pytest.mark.parametrize("d,n,c,kappa", CASES)
def test_port_solve_matches_the_reference_and_the_exact_solution(d, n, c, kappa):
    """tkt.solve by Arnoldi with the cell's tmax 513 and check cadence 16.
    Its true residual is at most tol = 1e-8 (the benchmark's own limit), so
    its forward error is at most κ·1e-8 (κ₂(A) ≈ κ for these near-normal
    factors), 10× that allowed for the eigenvector matrix's condition; the
    reference sits within 10·κ·1e-9 of the exact answer, so the two agree
    within the sum."""
    sigma = cd.sigma_for_kappa(n, kappa)
    b = rhs(d, n, 7 + d)
    op = tkt.conv_diff(d, n, c=c, shift=sigma, device="cpu")
    res = tkt.solve(op, b, tkt.SolverConfig(kmax=min(n, 200), tol=1e-8, orth="arnoldi", tmax=513, check_every=16))
    assert res.status == 1
    x = full(res.x.weights, res.x.factors)
    assert residual.relative_residual(cd.OFFSETS, cd.bands(d, n, c, sigma), res.x.weights, res.x.factors, b) <= 1e-8
    assert rel_err(x, exact(d, n, c, sigma, b)) <= 10 * 1e-8 * kappa
    w, X = cd.solve(d, n, c, sigma, b)
    assert rel_err(x, full(w, X)) <= 10 * (1e-8 + cd.TARGET) * kappa


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A checkout copy with the tiny cells and one of this family, added as
    files and entries only: d=3, n=64, κ = 1e2, kmax 64, reporting the
    Arnoldi cell's metrics."""
    spec, root, bench = tkbench_tiny.make(tmp_path_factory.mktemp("tiny"))
    cfg = json.loads((REPO / "tkbench" / "configs" / "convdiff_d10_n131072_kappa1e4.json").read_text())
    cfg.update(name="tiny_convdiff", operator=dict(cfg["operator"], d=3, n=64, kappa=1e2),
               solver=dict(cfg["solver"], kmax=64))
    (bench / "configs" / "tiny_convdiff.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(name="tiny_convdiff", source="https://doi.org/10.1137/090756843",
                                file="tkbench/configs/tiny_convdiff.json", reduced=["n"], why="CPU test size"))
    spec["workloads"].append(dict(name="tiny.arnoldi", config="tiny_convdiff", traffic="arnoldi", chips=1,
                                  why="CPU test size"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "convdiff_kappa1e4.arnoldi" in m.get("workloads", []):
            m["workloads"].append("tiny.arnoldi")
    return spec, root, bench


def _faulty(kind, op_cfg, b, x):
    """The port's answer x with a planted fault."""
    w, X = x.weights.clone(), x.factors.clone()
    if kind == "half_terms":
        w[1::2] = 0.0
    elif kind == "no_convection":
        d, n, _, sigma = cd._shape(op_cfg)
        plain = tkt.conv_diff(d, n, c=0.0, shift=sigma, device="cpu")
        y = tkt.solve(plain, b, tkt.SolverConfig(kmax=64, tol=1e-8, orth="arnoldi", tmax=513, check_every=16)).x
        w, X = y.weights, y.factors
    elif kind == "float32":
        w, X = w.float(), X.float()
    return w, X


@pytest.mark.parametrize("kind", ["port", "half_terms", "no_convection", "float32"])
def test_judge_on_a_tiny_cell(tiny, kind):
    """The run's comparison on the port's answers: correct, and not correct
    once half the exp-sum terms are dropped, once x solves the operator
    without its convection bands, or once the answer is rounded to float32."""
    spec, root, bench = tiny
    c = harness.cell(spec, "tiny.arnoldi", root, bench)
    cfg, ref = c["config"], c["reference"]
    pool = torch.stack([rhs(3, 64, s) for s in (1, 2)])
    fn, args = ref.program_operator(cfg["operator"])
    op = getattr(tkt, fn)(**args, device="cpu")
    config = tkt.SolverConfig(**{k: getattr(torch, v) if k.endswith("dtype") else v for k, v in cfg["solver"].items()})
    samples, results = [], []
    for i in range(2):
        res = tkt.solve(op, pool[i], config)
        results.append(dict(status=res.status, niterations=res.niterations))
        w, X = _faulty(kind, cfg["operator"], pool[i], res.x)
        samples.append(dict(rhs=i, weights=w, factors=X, claimed=0.0))
    checks = harness.judge(cfg, ref, pool, samples, results, CPU)
    assert checks["unconverged"]["value"] == 0 and checks["checked"]["value"] == 2
    assert harness._correct(checks) is (kind == "port"), checks


def test_the_float32_control_fails_the_tiny_cell(tiny):
    """The reference in float32 in the program's place does not pass."""
    spec, root, bench = tiny
    out = control.control(spec, "tiny.arnoldi", 2 ** 31 + 5, torch.float32, CPU, root, bench)
    assert out["passes"] is False and out["checks"]["resid_max"]["value"] > 1e-8


def _traced(op, b, config):
    with profiling.tracing():
        res = tkt.solve(op, b, config)
    return res, profiling.solve_records()[-1]


def test_nonsymmetric_check_opens_its_two_spans():
    """Each nonsymmetric check opens 'solve.check.bendixson' and
    'solve.check.eig' once, inside it; the eig counts as one host read of
    the check. A symmetric solve's checks open neither."""
    d, n = 3, 48
    sigma = cd.sigma_for_kappa(n, 1e2)
    b = rhs(d, n, 3)
    cfg = tkt.SolverConfig(kmax=48, tol=1e-8, orth="arnoldi", tmax=513, check_every=8)
    res, rec = _traced(tkt.conv_diff(d, n, shift=sigma, device="cpu"), b, cfg)
    names = [s.name for s in rec.spans]
    checks = [s for s in rec.spans if s.name == "solve.check"]
    assert len(checks) == res.niterations // 8 >= 2
    for name in ("solve.check.bendixson", "solve.check.eig"):
        inside = [s for s in rec.spans if s.name == name]
        assert len(inside) == len(checks) and all(s.parent.name == "solve.check" for s in inside)
        assert sorted({id(s.parent) for s in inside}) == sorted(id(s) for s in checks)
        assert all(s.host_reads == (name == "solve.check.eig") for s in inside)
    # a lucky-breakdown read a step, the eig and the status read a check
    assert rec.root.host_reads == res.niterations + 2 * len(checks)
    assert names.count("solve.step") == res.niterations

    res, rec = _traced(tkt.reaction_diffusion(d, n, sigma, device="cpu"), b, tkt.SolverConfig(kmax=48, tol=1e-8))
    names = {s.name for s in rec.spans}
    assert "solve.check" in names and not names & {"solve.check.bendixson", "solve.check.eig"}


def test_step_roofline_counts_the_hand_numbers():
    """Step k = 160 at d=10, n=131072, 4 bands, f64: V[:160] read four times
    and the SpMV's bands, input and output, 8·10·131072·(640 + 6) bytes =
    6.77 GB, 2.02 ms at 3.35 TB/s."""
    m = harness.load_metric("arnoldi.step_roofline")
    nbytes = m.work((10, 4, 131072), 160, 8)
    assert nbytes == 6_773_800_960
    assert nbytes / 3.35e12 == pytest.approx(2.022e-3, rel=1e-3)
    assert m.work((10, 4, 131072), 1, 8) == 8 * 10 * 131072 * 10


def test_step_roofline_reads_the_step_spans(monkeypatch):
    """The share: the bounds of each solve's steps, step k its k-th step
    span, against the spans' device time; none without one recorded shape
    or off the card (no device ms)."""
    m = harness.load_metric("arnoldi.step_roofline")
    step = lambda ms: type("S", (), dict(name="solve.step", device_ms=ms))
    other = type("S", (), dict(name="solve.check", device_ms=5.0))
    recs = [type("R", (), dict(spans=(other, step(1.0), other, step(2.0))))] * 2
    monkeypatch.setattr(m, "records", lambda t: recs)
    shape = ((10, 4, 131072), 8)
    t = type("T", (), dict(peaks={"hbm_bytes_per_s": 3.35e12}, records={m.NAME: [shape, shape]}))
    bound = 2 * (m.work(shape[0], 1, 8) + m.work(shape[0], 2, 8)) / 3.35e12
    assert m.read(t) == pytest.approx(100 * bound / 6e-3)
    t.records = {m.NAME: [shape, ((10, 3, 131072), 8)]}
    assert m.read(t) is None
    t.records = {m.NAME: [shape]}
    monkeypatch.setattr(m, "records", lambda t: [type("R", (), dict(spans=(step(None),)))])
    assert m.read(t) is None
