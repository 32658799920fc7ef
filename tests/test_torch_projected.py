"""The port's projected stage — eigh, coefficient selection, CP solve,
Lemma-3.4 residual and projected_step — against the JAX package, in f64 on
the same numpy inputs."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
from tensorkrylov_tpu.coeffs import tables as jtables
from tensorkrylov_tpu.ops import eigen as jeigen, expsum as jexpsum, gram as jgram, orth as jorth
from tensorkrylov_tpu.solver import projected_step as jax_projected_step
from tensorkrylov_tpu_torch.coeffs import tables
from tensorkrylov_tpu_torch.interop import config_from_fields, operator_from_numpy, tables_from_numpy
from tensorkrylov_tpu_torch.models.gallery import rand_spd
from tensorkrylov_tpu_torch.ops import eigen, expsum, gram
from tensorkrylov_tpu_torch.solver import projected_step

T = torch.tensor
RTOL = 1e-12  # f64, other LAPACK/BLAS call orders


def _close(got, ref, rtol=RTOL, atol=0.0):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=1)
def _krylov_arrays(k=12, d=3, n=30, kmax=20):
    jop = tk.laplace(d, n)
    jb = tk.random_rhs(d, n, seed=4, identical=False)
    st, bn = jorth.init_state(jop, jb, kmax, jnp.float64)
    step = jax.jit(functools.partial(jorth.lanczos_step, reorth=True, proj_dtype=jnp.float64))
    for j in range(1, k + 1):
        st, _ = step(jop, st, jb, j)
    return jop, np.asarray(st.H), np.asarray(st.btil), float(np.prod(np.asarray(bn)))


def _krylov():
    """H, b̃ after 12 reorthogonalized Lanczos steps (JAX) at d=3, n=30,
    padded to kmax+1 = 21; fresh copies for each caller."""
    jop, H, btil, bnp = _krylov_arrays()
    return jop, H.copy(), btil.copy(), bnp


@pytest.mark.parametrize("k", [1, 5, 21])
def test_masked_eigh_matches_jax(k):
    _, H, _, _ = _krylov()
    jw, jQ = jax.jit(jeigen.masked_eigh, static_argnums=1)(jnp.asarray(H), k)
    w, Q = eigen.masked_eigh(T(H), k)
    scale = np.max(np.abs(np.asarray(jw)))
    _close(w, jw, rtol=0, atol=1e-13 * scale)
    # eigenvectors may differ in sign: compare the reconstructed matrices
    rec = Q @ torch.diag_embed(w) @ Q.transpose(1, 2)
    jrec = np.asarray(jQ) @ (np.asarray(jw)[:, :, None] * np.swapaxes(np.asarray(jQ), 1, 2))
    _close(rec, jrec, rtol=0, atol=1e-12 * scale)


def test_dense_minor_window_and_analytic_extremes_match_jax():
    op = rand_spd(2, 9, seed=1, device="cpu")  # the port's gallery draws as the JAX package's does
    jop = tk.KroneckerSumOperator(jnp.asarray(op.bands.numpy()), op.offsets, True)
    jwindow = jax.jit(jeigen.dense_minor_window, static_argnums=1)
    for K in (4, 9, 12):
        _close(eigen.dense_minor_window(op, K), jwindow(jop, K), rtol=0, atol=0)
    jextremes = jax.jit(jeigen.analytic_laplace_extremes, static_argnums=(0, 1))
    for k in (1, 7, 30):
        lo, hi = eigen.analytic_laplace_extremes(3, 30, k)
        jlo, jhi = jextremes(3, 30, k)
        _close(lo, jlo)
        _close(hi, jhi)


@pytest.mark.parametrize("tmax", [20, 63, 101])
@pytest.mark.parametrize("row_select", ["ceil", "reference"])
def test_select_bh_matches_jax_over_kappa_grid(row_select, tmax):
    jt = jtables.load_tables()
    pt = tables.load_tables()
    jselect = jax.jit(jtables.select_bh, static_argnames=("tmax", "row_select"))
    for kappa in np.concatenate([[1.0, 2.0, 9.3, 10.0, 99.99], np.logspace(0.5, 11.5, 23)]):
        for tol in (1e-6, 1e-9 / kappa, 1e-14):
            ref = jselect(jnp.asarray(kappa), tol, jt, tmax=tmax, row_select=row_select)
            got = tables.select_bh(T(kappa), tol, pt, tmax, row_select)
            assert int(got.rank) == int(ref.rank), (kappa, tol)
            for g, r in zip(got, ref):
                _close(g, r, rtol=0, atol=0)


def test_tables_from_numpy_equals_load_tables():
    arrays = {f: np.asarray(getattr(jtables.load_tables(), f)) for f in jtables.BHTables._fields}
    for a, b in zip(tables_from_numpy(arrays), tables.load_tables()):
        assert torch.equal(a, b)


def test_select_stenger_matches_jax():
    jselect = jax.jit(jtables.select_stenger, static_argnums=1)
    for tmax in (63, 101, 601):
        for eps in (1e-3, 3.7e-7, 1e-10, 1e-16):
            ref = jselect(eps, tmax)
            got = tables.select_stenger(eps, tmax)
            assert int(got.rank) == int(ref.rank)
            for g, r in zip(got, ref):
                _close(g, r, rtol=1e-14, atol=1e-300)


def test_cp_solve_sym_matches_jax():
    _, H, btil, _ = _krylov()
    k = 12
    jw, jQ = jax.jit(jeigen.masked_eigh, static_argnums=1)(jnp.asarray(H), k)
    coeffs = jax.jit(jtables.select_bh)(jnp.asarray(40.0), 1e-10, jtables.load_tables())
    args = [coeffs.omega, coeffs.alpha, coeffs.t_mask, jnp.asarray(5.0)]
    jweights, jY = jax.jit(jexpsum.cp_solve_sym, static_argnums=3)(jw, jQ, jnp.asarray(btil), k, *args)
    weights, Y = expsum.cp_solve_sym(T(np.asarray(jw)), T(np.asarray(jQ)), T(btil), k,
                                     *(T(np.asarray(a)) for a in args))
    _close(weights, jweights)
    _close(Y, jY, rtol=0, atol=1e-13 * np.max(np.abs(np.asarray(jY))))


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8])
def test_gram_scans_match_jax(d):
    """The mode reductions follow lax.associative_scan's tree for any d."""
    rng = np.random.default_rng(d)
    t = 7
    Gy, Gz, X = (rng.standard_normal((d, t, t)) for _ in range(3))
    w = rng.standard_normal(t)
    _close(gram.mv_norm_sq(*map(T, (Gy, Gz, X, w))),
           jax.jit(jgram.mv_norm_sq)(*map(jnp.asarray, (Gy, Gz, X, w))), rtol=1e-14)
    Ym, Z, bt = rng.standard_normal((d, 9, t)), rng.standard_normal((d, 9, t)), rng.standard_normal((d, 9))
    _close(gram.tensor_inner_prod(*map(T, (Ym, Z, bt, w))),
           jax.jit(jgram.tensor_inner_prod)(*map(jnp.asarray, (Ym, Z, bt, w))), rtol=1e-14)
    _close(gram.excluded_products(T(Gy)), jax.jit(jgram.excluded_products)(jnp.asarray(Gy)), rtol=1e-14)


def test_residual_norm_sq_matches_jax():
    _, H, btil, _ = _krylov()
    k = 12
    rng = np.random.default_rng(9)
    Y = rng.standard_normal((3, H.shape[1], 15)) * (np.arange(H.shape[1]) < k)[None, :, None]
    w = rng.standard_normal(15)
    sub = H[:, k, k - 1]
    ref = jax.jit(jgram.residual_norm_sq, static_argnums=3)(*map(jnp.asarray, (H, Y, btil)), k, jnp.asarray(w),
                                                           jnp.asarray(sub))
    got = gram.residual_norm_sq(T(H), T(Y), T(btil), k, T(w), T(sub))
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-12)


@pytest.mark.parametrize("fields", [
    dict(),
    dict(spectral_source="A_minor"),
    dict(spectral_source="analytic_laplace"),
    dict(tmax=101),
    dict(identical_factors=True),
    dict(coeff_tol_scale="reference", bh_row_select="reference"),
], ids=["H", "A_minor", "analytic_laplace", "tmax101", "identical", "reference_rules"])
def test_projected_step_matches_jax(fields):
    jop, H, btil, bnp = _krylov()
    if fields.get("identical_factors"):  # identical factors need identical start vectors
        H, btil = np.broadcast_to(H[:1], H.shape).copy(), np.broadcast_to(btil[:1], btil.shape).copy()
    k, n = 12, jop.n
    K = H.shape[1]
    jcfg = tk.SolverConfig(kmax=K - 1, tol=1e-9, **fields)
    cfg = config_from_fields({f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    op = operator_from_numpy(np.asarray(jop.bands), jop.offsets)
    jW = jeigen.dense_minor_window(jop, K) if jcfg.spectral_source == "A_minor" else None
    W = eigen.dense_minor_window(op, K) if cfg.spectral_source == "A_minor" else None
    jstep = jax.jit(jax_projected_step, static_argnames=("config", "symmetric", "n"))
    ref = jstep(jnp.asarray(H), jnp.asarray(btil), jnp.asarray(H[:, k, k - 1]), k, jnp.asarray(bnp),
                config=jcfg, tables=jtables.load_tables(), symmetric=True, n=n, W_A=jW)
    got = projected_step(T(H), T(btil), T(H[:, k, k - 1]), k, T(bnp, dtype=torch.float64), cfg, tables.load_tables(), True, n, W)
    assert int(got.rank) == int(ref.rank) and bool(got.breakdown) == bool(ref.breakdown)
    for name in ("weights", "rel", "lmin", "lmax"):
        _close(getattr(got, name), getattr(ref, name), rtol=1e-10)
    # r_comp² = ‖Hy‖² − 2⟨Hy, b̃⟩ + ‖b̃‖² cancels: it is known to within the
    # solver's own noise band, cancel_floor_rel·eps·(‖Hy‖² + ‖b̃‖²)
    scale = float(gram.residual_norm_sq(T(H), got.Y, T(btil), k, got.weights, T(H[:, k, k - 1])).cancel_scale)
    band = cfg.cancel_floor_rel * np.finfo(np.float64).eps * scale
    assert abs(float(got.r_comp) ** 2 - float(ref.r_comp) ** 2) <= band
    _close(got.Y, ref.Y, rtol=0, atol=1e-12 * np.max(np.abs(np.asarray(ref.Y))))
