"""The port's experiment modules (eigenvalue_distribution, parameterized_systems,
plotting) on the CPU: against the JAX package's on the same inputs
(tests/test_experiments.py's cases; its northstar case waits for the port of
experiments/northstar.py)."""
import numpy as np
import pytest
import torch

from tensorkrylov_tpu.experiments import eigenvalue_distribution as jed, parameterized_systems as jps
from tensorkrylov_tpu_torch.experiments import eigenvalue_distribution as ed, parameterized_systems as ps, plotting

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
