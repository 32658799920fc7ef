"""The port's deflated solver on the CPU, alone: the storages against each
other ('full', 'twopass', 'segmented'), the state cache, the options that
are not ported, and the fast twins of tests/test_deflate.py's slow tests
(storage='df64': tests/test_torch_df64.py),
held to the dense oracle and to the JAX tests' bounds
(tests/test_torch_deflate.py holds the port against the JAX package)."""
import warnings

import numpy as np
import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.ops import banded
from tensorkrylov_tpu_torch.ops.orth import deflation_project, init_state, lanczos_step

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)


def _unit_rows(d, n, seed):
    b = tkt.random_rhs(d, n, seed=seed).numpy()
    return b / np.linalg.norm(b, axis=1, keepdims=True)


# tests/test_deflate.py's twopass case: (operator, b, config fields, solve_deflated keywords)
TWOPASS = (lambda: tkt.laplace(2, 64, shift=30.0, device="cpu"), _unit_rows(2, 64, 5), dict(kmax=24, tol=1e-12),
           dict(m=6, storage="twopass", checkpoints=[8, 16, 24]))


def test_structured_residual_norm_matches_materialized():
    """cp_residual_norm_accurate (indexed Gram) equals the norm of the
    materialized CP residual on an unconverged deflated solve."""
    from tensorkrylov_tpu_torch.utils.cp import cp_norm_accurate, cp_residual_norm_accurate

    op = tkt.reaction_diffusion(3, 24, sigma=300.0, device="cpu")
    b = torch.tensor(_unit_rows(3, 24, 0))
    r = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=4, tol=1e-10), basis=tkt.deflation_basis(op, 5))
    old = cp_norm_accurate(tkt.cp_residual(op, r.x, b))
    new = cp_residual_norm_accurate(op, r.x, b)
    assert abs(new - old) <= 1e-10 * old
    assert abs(new - tkt.kron_residual_dense(op, r.x, b)) < 1e-8
    np.testing.assert_allclose(r.measured_cp_residual, new, rtol=1e-12)


def test_deflated_solve_certified_vs_dense_oracle():
    op = tkt.laplace(3, 30, shift=50.0, device="cpu")
    b = tkt.random_rhs(3, 30, seed=7)
    res = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=30, tol=1e-7), m=6, checkpoints=[8, 16, 24, 30])
    assert res.converged and res.x.factors.device.type == "cpu"
    true_r = tkt.kron_residual_dense(op, res.x, b)
    assert true_r <= res.certified_bound[-1] + 1e-14 and true_r < 1e-7
    assert res.relative_residual[0] > res.relative_residual[-1]


def test_deflation_reduces_iterations():
    """Fewer Krylov steps to the same certificate on a stiff problem."""
    n, d = 40, 2
    op = tkt.laplace(d, n, shift=1.0, device="cpu")
    b = tkt.random_rhs(d, n, seed=11)
    cks = list(range(4, n + 1, 4))
    plain = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=n, tol=1e-6), m=1, checkpoints=cks, certify=False)
    defl = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=n, tol=1e-6), m=12, checkpoints=cks, certify=False)
    assert defl.converged and defl.niterations < plain.niterations
    assert defl.measured_cp_residual is None


def test_lanczos_step_deflate_U_stays_U_orthogonal():
    """lanczos_step(deflate_U=U) keeps the basis in the U-complement; the
    fused core cannot project and raises."""
    op = tkt.laplace(2, 30, shift=5.0, device="cpu")
    U = torch.tensor(tkt.deflation_basis(op, 5).U)
    b = tkt.random_rhs(2, 30, seed=1)
    b_perp = deflation_project(b, U)
    state, _ = init_state(op, b_perp, 8, torch.float64)
    for k in range(1, 9):
        state, _ = lanczos_step(op, state, b_perp, k, reorth=False, proj_dtype=torch.float64, deflate_U=U)
    assert torch.einsum("nm,kdn->kdm", U[0], state.V).abs().max() < 1e-12
    with pytest.raises(ValueError, match="deflate_U"):
        lanczos_step(op, state, b_perp, 8, reorth=False, proj_dtype=torch.float64, fused=True, deflate_U=U)


def test_lucky_restart_stays_in_U_complement():
    """A lucky breakdown's restart direction is projected into the
    U-complement: b in the span of 3 eigenvectors, deflated by 2 of them,
    exhausts the space at the first step."""
    n = 20
    op = tkt.laplace(1, n, shift=5.0, device="cpu")
    U_all = torch.tensor(tkt.deflation_basis(op, 5).U)
    U = U_all[:, :, :2]
    b = (U_all[0, :, 0] + U_all[0, :, 2])[None]
    b_perp = deflation_project(b, U)
    state, _ = init_state(op, b_perp, 3, torch.float64)
    for k in range(1, 4):
        state, _ = lanczos_step(op, state, b_perp, k, reorth=True, proj_dtype=torch.float64, deflate_U=U)
    assert float(state.H[0, 1, 0]) == 0.0                           # the breakdown happened
    assert torch.einsum("nm,kdn->kdm", U[0], state.V).abs().max() < 1e-12
    G = torch.einsum("kdn,jdn->dkj", state.V, state.V)[0]
    assert (G - torch.eye(4, dtype=G.dtype)).abs().max() < 1e-12


def test_deflated_input_validation():
    with pytest.raises(ValueError, match="symmetric"):
        tkt.solve_deflated(tkt.conv_diff(2, 16, device="cpu"), tkt.random_rhs(2, 16, seed=0), m=2)
    op = tkt.laplace(2, 16, device="cpu")
    b = tkt.random_rhs(2, 16, seed=0)
    for m in (0, 16):
        with pytest.raises(ValueError, match="0 < m < n"):
            tkt.deflation_basis(op, m)
    with pytest.raises(ValueError, match=r"b must be \(d, n\)"):
        tkt.solve_deflated(op, b[:1], m=2)
    with pytest.raises(ValueError, match="Lanczos-family"):
        tkt.solve_deflated(op, b, tkt.SolverConfig(orth="arnoldi"), m=2)
    with pytest.raises(ValueError, match="storage must be"):
        tkt.solve_deflated(op, b, m=2, storage="dense")
    with pytest.raises(ValueError, match="state_cache requires"):
        tkt.solve_deflated(op, b, m=2, storage="full", state_cache="x.npz")
    with pytest.raises(ValueError, match="pass2_impl='host' requires"):
        tkt.solve_deflated(op, b, m=2, storage="full", pass2_impl="host")
    with pytest.raises(ValueError, match="segment must be"):
        tkt.solve_deflated(op, b, m=2, storage="segmented", segment=0)


def test_twopass_storage_matches_full():
    """orth='lanczos': the basis-free storage runs the stored-basis storage's
    step, so T, b̃ and every bound are equal bit for bit; pass 2's x within
    1e-12, with its replay audit at 0."""
    op = tkt.laplace(3, 30, shift=50.0, device="cpu")
    b = tkt.random_rhs(3, 30, seed=7)
    cfg = tkt.SolverConfig(kmax=30, tol=1e-7, orth="lanczos")
    kw = dict(m=6, checkpoints=[8, 16, 24], certify=False)
    r_full = tkt.solve_deflated(op, b, cfg, storage="full", **kw)
    r_two = tkt.solve_deflated(op, b, cfg, storage="twopass", **kw)
    assert (r_two.status, r_two.niterations) == (r_full.status, r_full.niterations)
    assert r_two.certified_bound == r_full.certified_bound and r_two.relative_residual == r_full.relative_residual
    np.testing.assert_allclose(r_two.x.factors.numpy(), r_full.x.factors.numpy(), atol=1e-12, rtol=1e-10)
    assert r_two.pass2_beta_rel_dev == 0.0 and r_full.pass2_beta_rel_dev is None
    assert tkt.kron_residual_dense(op, r_two.x, b) <= r_two.certified_bound[-1] + 1e-14


def test_deflated_solve_b_in_span_U():
    """b_s inside span(U_s): that factor's recurrence freezes at zero (no NaN)
    and the U-block solves it exactly, on every storage."""
    op = tkt.laplace(2, 20, shift=5.0, device="cpu")
    basis = tkt.deflation_basis(op, 4)
    U0 = basis.U[0]
    b = np.zeros((2, 20))
    b[0] = U0[:, 0] + 0.5 * U0[:, 2]
    b[1] = np.random.default_rng(0).standard_normal(20)
    for storage in ("full", "twopass", "segmented"):
        r = tkt.solve_deflated(op, torch.tensor(b), tkt.SolverConfig(kmax=20, tol=1e-7), basis=basis,
                               checkpoints=[6, 12, 16], storage=storage, segment=4)
        assert r.converged, storage
        assert bool(torch.isfinite(r.x.factors).all()) and np.isfinite(r.certified_bound).all()
        assert tkt.kron_residual_dense(op, r.x, b) <= r.certified_bound[-1] + 1e-12


def test_pass2_audit_and_cross_check_floor():
    """twopass returns the replay audit (0 deviation: pass 2 repeats pass 1
    bit for bit) and the cross-check's floor; the measurement resolves the
    true residual or is floored."""
    op = tkt.laplace(2, 36, shift=30.0, device="cpu")
    b = torch.tensor(_unit_rows(2, 36, 5))
    r = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=16, tol=1e-10), m=6, storage="twopass")
    assert r.pass2_beta_rel_dev == 0.0
    assert r.pass2_gram_max is not None and r.pass2_gram_max < 1e-8
    assert r.cp_residual_floor is not None and r.cp_residual_floor > 0.0
    true_r = tkt.kron_residual_dense(op, r.x, b)
    if r.measured_cp_residual > r.cp_residual_floor:
        assert abs(r.measured_cp_residual - true_r) < 10 * r.cp_residual_floor
    else:
        assert true_r < 10 * max(r.cp_residual_floor, 1e-15)
    rf = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=16, tol=1e-10), m=6, storage="full")
    assert rf.pass2_gram_max is None


def test_project_every_stride_matches_per_step():
    """The strided projection reproduces the per-step solve, with the
    measured leak at the amplified-roundoff level; it warns."""
    op = tkt.laplace(2, 64, shift=30.0, device="cpu")
    b = torch.tensor(_unit_rows(2, 64, 5))
    cfg = tkt.SolverConfig(kmax=20, tol=1e-12)
    r1 = tkt.solve_deflated(op, b, cfg, m=6, storage="twopass", project_every=1)
    with pytest.warns(RuntimeWarning, match="project_every=8"):
        r8 = tkt.solve_deflated(op, b, cfg, m=6, storage="twopass", project_every=8)
    t1, t8 = tkt.kron_residual_dense(op, r1.x, b), tkt.kron_residual_dense(op, r8.x, b)
    assert abs(t8 - t1) / max(t1, 1e-300) < 1e-4
    assert r1.projection_leak < 1e-13 and r8.projection_leak < 1e-8
    with pytest.warns(RuntimeWarning):
        rf = tkt.solve_deflated(op, b, cfg, m=6, storage="full", project_every=4)
    assert abs(tkt.kron_residual_dense(op, rf.x, b) - t1) / max(t1, 1e-300) < 1e-4
    assert rf.projection_leak is None


def test_segmented_storage_matches_full():
    """segmented = full to 1e-3 in the true residual, the measured boundary
    drift at roundoff; checkpoints snap to whole segments."""
    op = tkt.laplace(2, 64, shift=30.0, device="cpu")
    b = torch.tensor(_unit_rows(2, 64, 5))
    cfg = tkt.SolverConfig(kmax=24, tol=1e-12)
    rf = tkt.solve_deflated(op, b, cfg, m=6, storage="full")
    rs = tkt.solve_deflated(op, b, cfg, m=6, storage="segmented", segment=8)
    tf, ts = tkt.kron_residual_dense(op, rf.x, b), tkt.kron_residual_dense(op, rs.x, b)
    assert abs(ts - tf) / tf < 1e-3 and ts <= rs.certified_bound[-1] + 1e-12
    assert rs.boundary_drift_max is not None and rs.boundary_drift_max < 1e-10
    r2 = tkt.solve_deflated(op, b, cfg, m=6, storage="segmented", segment=8, checkpoints=[13])
    assert r2.checkpoints == [8] and all(c % 8 == 0 for c in r2.checkpoints)


def test_state_cache_resume_equals_uninterrupted(tmp_path):
    """A twopass solve stopped at checkpoint 8 and resumed from its cache
    gives the uninterrupted run's bounds, estimates and x bit for bit; the
    resumed run's SpMVs are the remaining steps and pass 2's."""
    make, b, fields, kw = TWOPASS
    op, b, cfg = make(), torch.tensor(b), tkt.SolverConfig(**fields)
    path = str(tmp_path / "state.npz")
    full = tkt.solve_deflated(op, b, cfg, **kw)
    tkt.solve_deflated(op, b, cfg, **{**kw, "checkpoints": [8]}, state_cache=path)
    with np.load(path) as z:
        assert int(z["k_prev"]) == 9 and z["od"].shape == (2, 25)
    calls = []
    real = banded.spmv_reference
    try:
        banded.spmv_reference = lambda o, v: calls.append(1) or real(o, v)
        resumed = tkt.solve_deflated(op, b, cfg, **kw, state_cache=path)
    finally:
        banded.spmv_reference = real
    assert resumed.certified_bound == full.certified_bound
    assert resumed.relative_residual == full.relative_residual
    assert torch.equal(resumed.x.factors, full.x.factors)
    k = full.niterations
    assert len(calls) == (k - 8) + (k - 1)            # pass 1 after the resume, then pass 2
    with pytest.raises(ValueError, match="project_every"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            tkt.solve_deflated(op, b, cfg, **kw, state_cache=path, project_every=2)


def test_state_cache_refuses_another_problem(tmp_path):
    make, b, fields, kw = TWOPASS
    op, cfg = make(), tkt.SolverConfig(**fields)
    path = str(tmp_path / "state.npz")
    tkt.solve_deflated(op, torch.tensor(b), cfg, **{**kw, "checkpoints": [8]}, state_cache=path)
    with pytest.raises(ValueError, match="different problem"):
        tkt.solve_deflated(op, torch.tensor(_unit_rows(2, 64, 6)), cfg, **kw, state_cache=path)
    with pytest.raises(ValueError, match="stale cache"):
        tkt.solve_deflated(op, torch.tensor(b), tkt.SolverConfig(**{**fields, "kmax": 20}), **kw, state_cache=path)


def test_pass2_host_equals_device():
    """pass2_impl='host' (the numpy twin) and the torch replay: the same x and
    audit from the same pass 1."""
    make, b, fields, kw = TWOPASS
    op = make()
    rd = tkt.solve_deflated(op, torch.tensor(b), tkt.SolverConfig(**fields), **kw, pass2_impl="device")
    rh = tkt.solve_deflated(op, torch.tensor(b), tkt.SolverConfig(**fields), **kw, pass2_impl="host")
    assert rd.certified_bound == rh.certified_bound
    np.testing.assert_allclose(rh.x.factors.numpy(), rd.x.factors.numpy(), rtol=0, atol=1e-13)
    assert rh.pass2_beta_rel_dev < 1e-13 and rd.pass2_beta_rel_dev == 0.0


def test_device_cross_check_resolves_below_the_f64_floor():
    """The device cross-check's compensated Gram resolves the true residual
    (the dense oracle, 1.8e-9 here) within its floor (~6.6e-10), where the
    host's f64 Gram, the JAX package's, reads at or below its own floor of
    3e-8: an f64 Gram entry carries only ~√n·eps, and its noise in the
    cancelling pair sum reads above that floor at the flagship's size."""
    from tensorkrylov_tpu_torch.utils.cp import cp_residual_cross_check_device

    op = tkt.laplace(3, 30, shift=50.0, device="cpu")
    b = tkt.random_rhs(3, 30, seed=7)
    r = tkt.solve_deflated(op, b, tkt.SolverConfig(kmax=30, tol=1e-7), m=6)
    true_r = tkt.kron_residual_dense(op, r.x, b)
    assert r.measured_cp_residual <= r.cp_residual_floor and r.cp_residual_floor > 1e-8 > true_r
    check = cp_residual_cross_check_device(op, r.x.weights, r.x.factors, b)
    b_norm = float(np.prod(np.linalg.norm(b.numpy(), axis=1)))
    value, floor = check.value / b_norm, check.floor / b_norm
    assert floor < 1e-9 < true_r and value > floor
    assert abs(value - true_r) <= floor
