"""The port's experiment modules (eigenvalue_distribution, parameterized_systems,
plotting, northstar, nonsym_scale) on the CPU: against the JAX package's on the
same inputs (tests/test_experiments.py's cases), the north-star runner end to
end at a small size, and the nonsymmetric runner against the JAX runner at
the JAX runner's documented CPU size."""
import json

import numpy as np
import pytest
import torch

from tensorkrylov_tpu.experiments import eigenvalue_distribution as jed, northstar as jns, parameterized_systems as jps
from tensorkrylov_tpu_torch.experiments import eigenvalue_distribution as ed, northstar as ns, parameterized_systems as ps
from tensorkrylov_tpu_torch.experiments import plotting

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)


def test_families_match_jax():
    cz, co = ed.clusterzero(10), ed.clusterone(10)
    assert cz[0] == 0.01 and cz[-1] == 1.0
    assert co[0] == 0.01 and abs(co[-1] - 1.0) < 1e-12
    U = ed.uniform_eigenvalues(5, 3, (1.0, 2.0))
    assert U.shape == (3, 5) and not np.allclose(U[0], U[1])
    np.testing.assert_array_equal(cz, jed.clusterzero(10))
    np.testing.assert_array_equal(co, jed.clusterone(10))
    np.testing.assert_array_equal(U, jed.uniform_eigenvalues(5, 3, (1.0, 2.0)))


def test_multiset_spectrum_matches_full():
    ev = np.array([1.0, 2.5, 4.0])
    full = np.sort(ed.kronsum_spectrum(np.broadcast_to(ev, (3, 3))))
    vals, counts = ed.kronsum_spectrum_multiset(ev, 3)
    assert counts.sum() == 3**3
    np.testing.assert_allclose(np.sort(np.repeat(vals, counts)), full, rtol=1e-14)
    jvals, jcounts = jed.kronsum_spectrum_multiset(ev, 3)
    np.testing.assert_array_equal(vals, jvals)
    np.testing.assert_array_equal(counts, jcounts)
    with pytest.raises(ValueError, match="exceeds limit"):
        ed.kronsum_spectrum(np.ones((3, 10)), limit=100)


def test_perturbed_spectrum():
    P = ed.perturb_eigenvalues(np.array([1.0, 2.0]), 3, 0.1)
    np.testing.assert_allclose(P[0], [1.1, 2.1])
    np.testing.assert_allclose(P[2], [1.3, 2.3])
    np.testing.assert_array_equal(P, jed.perturb_eigenvalues(np.array([1.0, 2.0]), 3, 0.1))


def _same_runs(got, ref, rtol):
    assert sorted(got) == sorted(ref)
    for d in ref:
        g, r = got[d], ref[d]
        assert (g["status"], g["niterations"]) == (r["status"], r["niterations"]), d
        np.testing.assert_allclose(g["relative_residual"], r["relative_residual"], rtol=rtol)


@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_eigenvalue_experiment_matches_jax(eps):
    """Both families (and the uniform one), reorthogonalized Lanczos, d = 2, 3,
    n = 12: the traces of the two packages to 1e-8."""
    kw = dict(dims=(2, 3), n=12, tol=1e-9, eps=eps, verbose=False)
    got, ref = ed.eigenvalue_experiment(**kw, device="cpu"), jed.eigenvalue_experiment(**kw)
    for fam in ("clusterzero", "clusterone"):
        _same_runs(got[fam], ref[fam], 1e-8)
    if eps == 0.0:
        kw = dict(dims=(2,), n=12, verbose=False)
        _same_runs(ed.uniform_experiment(**kw, device="cpu")["uniform"], jed.uniform_experiment(**kw)["uniform"], 1e-8)


def test_parameterized_systems_match_jax():
    """The operators' bands, κ, and one SPD and one nonsymmetric solve at d=2,
    n=10 against the JAX package's (the nonsymmetric trace to 1e-6, as
    tests/test_torch_nonsym.py holds Arnoldi)."""
    np.testing.assert_array_equal(ps.parameterized_spd(3, 9, 2.3, device="cpu").bands.numpy(),
                                  np.asarray(jps.parameterized_spd(3, 9, 2.3).bands))
    np.testing.assert_array_equal(ps.parameterized_nonsym(3, 9, -4.0, device="cpu").bands.numpy(),
                                  np.asarray(jps.parameterized_nonsym(3, 9, -4.0).bands))
    np.testing.assert_allclose(ps.parameterized_cond(30, 2.2), jps.parameterized_cond(30, 2.2), rtol=1e-12)
    kw = dict(alpha=2.2, beta=-5.0, dims=(2,), n=10, tol=1e-9, verbose=False)
    got, ref = ps.parameterized_experiment(**kw, device="cpu"), jps.parameterized_experiment(**kw)
    _same_runs(got["spd"], ref["spd"], 1e-8)
    _same_runs(got["nonsym"], ref["nonsym"], 1e-6)


def test_plots_write_png(tmp_path):
    traces = ed.eigenvalue_experiment(dims=(2,), n=8, verbose=False, device="cpu")["clusterzero"]
    from tensorkrylov_tpu_torch import SolverConfig, eigval_matrix, random_rhs, solve

    res = solve(eigval_matrix(ed.clusterone(8), d=2, device="cpu"), random_rhs(2, 8, seed=1),
                SolverConfig(kmax=8, tol=1e-9))
    paths = [plotting.plot_convergence({"json": traces[2], "result": res}, str(tmp_path / "conv.png")),
             plotting.plot_orthogonality({"result": res}, str(tmp_path / "orth.png")),
             plotting.plot_spectrum_hist(ed.kronsum_spectrum(np.stack([ed.clusterzero(8)] * 2)),
                                         str(tmp_path / "hist.png"))]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_interpret_cross_check_branches():
    """A measurement above the certified bound is labelled a contradiction,
    never a confirmation; every branch's verdict is the JAX package's."""
    f = ns.interpret_cross_check
    assert f(None, 1e-9, 1e-9, 1e-8) is None
    assert "<= floor" in f(1e-10, 1e-9, 5e-9, 1e-8)
    assert "confirmation" in f(3e-9, 1e-9, 5e-9, 1e-8)
    assert "CONTRADICTED" in f(9.8e-6, 3e-8, 5.4e-9, 1e-8)
    assert "within tol" in f(8e-9, 1e-9, 5e-9, 1e-8)
    assert "NOT confirmed" in f(5e-8, 1e-9, None, 1e-8)
    for args in ((None, 1e-9, 1e-9, 1e-8), (1e-10, 1e-9, 5e-9, 1e-8), (3e-9, 1e-9, 5e-9, 1e-8),
                 (9.8e-6, 3e-8, 5.4e-9, 1e-8), (8e-9, 1e-9, 5e-9, 1e-8), (5e-8, 1e-9, None, 1e-8)):
        assert f(*args) == jns.interpret_cross_check(*args)
    for n, kappa in ((131072, 1e6), (16384, 1e5), (256, 1e3)):
        assert ns.sigma_for_kappa(n, kappa) == jns.sigma_for_kappa(n, kappa)


def test_northstar_main_on_the_cpu(tmp_path):
    """The runner end to end at d=3, n=256, κ=1e3, m=8, kmax=64 (short of
    tol: 3.6e-5 at k=64, as the JAX package's solve): its artifact written
    where --out says, the cross-check resolving the last estimate, the basis
    cached and loaded on a second run; then with --storage df64 --final
    device, the recorded-relation certificate of the same solve, its bounds
    within 1e-3 of storage 'full''s and its evidence in the artifact."""
    out, cache = tmp_path / "ns.json", str(tmp_path / "basis.npz")
    argv = ["--cpu", "--d", "3", "--n", "256", "--m", "8", "--kappa", "1e3", "--kmax", "64", "--out", str(out),
            "--basis-cache", cache]
    art = ns.main(argv)
    with open(out) as fh:
        saved = json.load(fh)
    assert saved == json.loads(json.dumps(art))
    res = saved["result"]
    assert res["checkpoints"] == [32, 64] and res["niterations"] == 64
    assert res["certified_bound"][1] < res["certified_bound"][0] and res["certified_bound"][1] < 1e-4
    assert abs(res["measured_cp_residual"] - res["relative_residual_estimate"][-1]) <= 1e-3 * res["measured_cp_residual"]
    assert "NOT confirmed" in res["cp_residual_interpretation"]
    assert saved["recipe"]["storage_resolved"] == "full" and saved["timing"]["device"] == "cpu"
    assert not saved["timing"]["basis_loaded"] and ns.main(argv)["timing"]["basis_loaded"]
    df64 = ns.main(argv + ["--storage", "df64", "--final", "device", "--state-cache", "none"])
    rec, res = df64["recipe"], df64["result"]
    assert rec["storage_resolved"] == "df64" and rec["final"] == "device"
    assert res["checkpoints"] == [32, 64] and res["niterations"] == 64
    np.testing.assert_allclose(res["certified_bound"], saved["result"]["certified_bound"], rtol=1e-3)
    assert res["gram_deviation"] < 1e-12 and res["relation_dev_term"] >= 0.0 and res["eft_eps_measured"] > 0.0


def test_config4_block_main_on_the_cpu(tmp_path):
    """The config-4 runner at d=3, n=128, κ=20: solve_block with the
    solve_multi_rhs comparison, then --recorded with deflation, each
    artifact written where --out says; the recorded run certifies tol."""
    from tensorkrylov_tpu_torch.experiments import config4_block

    base = ["--cpu", "--d", "3", "--n", "128", "--kappa", "20", "--kmax", "30", "--rank", "2"]
    plain = config4_block.main(base + ["--out", str(tmp_path / "plain.json")])
    assert plain["block"]["solver"] == "solve_block" and plain["block"]["status"] == 1
    assert plain["multi_rhs"]["status"] == [1, 1] and plain["block_vs_multi_matvec_ratio"] > 0.0
    rec = config4_block.main(base + ["--recorded", "--m", "8", "--final", "device", "--skip-multi",
                                     "--out", str(tmp_path / "rec.json")])
    with open(tmp_path / "rec.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(rec))
    blk = rec["block"]
    assert blk["solver"] == "solve_block_recorded" and blk["status"] == 1 and blk["deflation_m"] == 8
    assert blk["certified_bound"][-1] < 1e-8 and "multi_rhs" not in rec
    assert "CONTRADICT" not in blk["interpretation"]


def test_nonsym_scale_main_matches_jax(tmp_path, monkeypatch):
    """The nonsymmetric runner at the JAX runner's CPU size (--cpu --n 512
    --kappa 1e3 --kmax 120: d=10, tmax=801, Arnoldi) against the JAX runner
    at the same size: the same σ, status and steps, the estimate and the
    exp-sum rank of the check that ended the solve (read from the JAX
    solve's own history: its runner reports the check before) to 1e-6 (the
    Arnoldi traces' tolerance, tests/test_torch_nonsym.py), the
    cross-checks within twice the floor.
    Both cross-checks read the exp-sum's active columns: the JAX runner's
    host function is given only those (a zero-weight column adds exact
    zeros to its contraction), which spares it the (1 + d·801)² longdouble
    products. The JAX runner's compilation cache stays off."""
    import sys

    import tensorkrylov_tpu as jtk
    from tensorkrylov_tpu.experiments import nonsym_scale as jnsc
    from tensorkrylov_tpu.utils import cache as jcache, cp as jcp
    from tensorkrylov_tpu_torch.experiments import nonsym_scale as nsc

    host_check = jcp.cp_residual_cross_check_host

    def active_only(bands, offsets, weights, factors, b):
        act = np.flatnonzero(np.asarray(weights) != 0)
        return host_check(bands, offsets, np.asarray(weights)[act], np.asarray(factors)[:, :, act], b)

    monkeypatch.setattr(jcp, "cp_residual_cross_check_host", active_only)
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    solved, jax_solve = [], jtk.solve
    monkeypatch.setattr(jtk, "solve", lambda *a, **k: solved.append(jax_solve(*a, **k)) or solved[-1])
    size = ["--cpu", "--n", "512", "--kappa", "1e3", "--kmax", "120"]
    monkeypatch.setattr(sys, "argv", ["nonsym_scale"] + size + ["--out", str(tmp_path / "jax.json")])
    jnsc.main()
    with open(tmp_path / "jax.json") as fh:
        ref = json.load(fh)
    art = nsc.main(size + ["--out", str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(art))
    assert art["problem"] == ref["problem"] and art["timing"]["device"] == "cpu"
    mine, theirs = art["result"], ref["result"]
    for key in ("status", "converged", "niterations"):
        assert mine[key] == theirs[key], key
    k = int(solved[-1].niterations)
    assert mine["expsum_rank"] == int(np.asarray(solved[-1].expsum_rank)[k])
    np.testing.assert_allclose(mine["relative_residual"], np.asarray(solved[-1].relative_residual)[k], rtol=1e-6)
    assert mine["cp_residual_floor"] == pytest.approx(theirs["cp_residual_floor"], rel=1e-6)
    assert abs(mine["measured_cp_residual"] - theirs["measured_cp_residual"]) <= 2 * mine["cp_residual_floor"]


def test_nonsym_scale_reports_the_check_that_converged(tmp_path):
    """A CONVERGED run reports the estimate of its last check, step k, which
    is below tol (reading the histories up to k - 1 gave the check before,
    above tol)."""
    from tensorkrylov_tpu_torch.experiments import nonsym_scale as nsc

    art = nsc.main(["--cpu", "--d", "3", "--n", "128", "--kappa", "1e2", "--kmax", "96",
                    "--out", str(tmp_path / "port.json")])
    res = art["result"]
    assert res["converged"] and res["status"] == 1 and res["niterations"] % 16 == 0
    assert res["relative_residual"] < art["problem"]["tol"]

