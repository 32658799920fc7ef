"""The port's mode-sharded deflated solve (solve_deflated(mesh=) on 'full',
'twopass' and 'df64') on 8 CPU shard slots, and the Krylov steps written
once over shard pieces.

tests/test_sharding.py:116-179's case, laplace(2, 64, shift=30), seed 5,
m=6, on make_mesh(devices=[cpu] * 8, factor_parallel=2): the sharded solve
against the port's unsharded one (same status and steps, true residuals
within 1e-10, df64 bounds within rtol 1e-9 and cross-checks within twice the
larger floor, the JAX test's tolerances) and against the JAX package's
unsharded solve_deflated (the tolerances of tests/test_torch_deflate.py and
tests/test_torch_df64.py); the options a mesh refuses; the df64 pair SpMV
on halo-extended pieces bit-equal to the whole row's; and the one-piece steps
bit-equal to their outputs before the steps took pieces (the goldens below
are sha256 digests of those outputs, made from a seed). The JAX side never
runs sharded here, so no twin carries the slow mark of
test_solve_deflated_sharded_matches_single_device."""
import hashlib
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch import deflate_light, df64_core
from tensorkrylov_tpu_torch.ops import expansion as ex
from tensorkrylov_tpu_torch.ops.orth import (arnoldi_step, deflation_coeffs, deflation_subtract, init_state,
                                             lanczos_step)
from tensorkrylov_tpu_torch.parallel import make_mesh, shard_operator, shard_rhs
from tensorkrylov_tpu_torch.parallel.halo import triple_spmv_pairs_sharded
from tensorkrylov_tpu_torch.parallel.sharding import gather, shard_basis

torch.set_num_threads(1)

F64 = torch.float64
CPU8 = [torch.device("cpu")] * 8
# tests/test_torch_deflate.py: bounds to 1e-10 (atol 1e-15), estimates to the cancellation floor, x to 1e-10
BOUND_RTOL, BOUND_ATOL = 1e-10, 1e-15
EST_RTOL, EST_ATOL = 1e-10, 2.0 * math.sqrt(np.finfo(np.float64).eps)
X_ATOL = 1e-10
# tests/test_sharding.py:116-179: true residuals to 1e-10 absolute, df64 bounds to rtol 1e-9
TRUE_ATOL, DF64_RTOL = 1e-10, 1e-9
# the configs of tests/test_sharding.py's two tests
CONFIGS = {"twopass": dict(kmax=20, tol=1e-10), "full": dict(kmax=20, tol=1e-10), "df64": dict(kmax=16, tol=1e-10)}


def _b():
    b = np.asarray(tk.random_rhs(2, 64, seed=5))
    return b / np.linalg.norm(b, axis=1, keepdims=True)


def _op():
    return tkt.laplace(2, 64, shift=30.0, device="cpu")


def _mesh():
    return make_mesh(devices=CPU8, factor_parallel=2)


def _kw(storage):
    return dict(m=6, storage=storage, **(dict(final="device") if storage == "df64" else {}))


@pytest.fixture(scope="module")
def port_unsharded():
    cache = {}

    def run(storage):
        if storage not in cache:
            cache[storage] = tkt.solve_deflated(_op(), torch.tensor(_b()), tkt.SolverConfig(**CONFIGS[storage]),
                                                **_kw(storage))
        return cache[storage]

    return run


@pytest.fixture(scope="module")
def jax_unsharded():
    cache = {}

    def run(storage):
        if storage not in cache:
            cache[storage] = tk.solve_deflated(tk.laplace(2, 64, shift=30.0), jnp.asarray(_b()),
                                               tk.SolverConfig(**CONFIGS[storage]), **_kw(storage))
        return cache[storage]

    return run


def _sharded(storage, comm="gspmd", **extra):
    return tkt.solve_deflated(_op(), torch.tensor(_b()), tkt.SolverConfig(**CONFIGS[storage]), mesh=_mesh(),
                              comm=comm, **_kw(storage), **extra)


@pytest.mark.parametrize("storage, comm", [("twopass", "gspmd"), ("twopass", "ring"), ("full", "gspmd"),
                                           ("full", "ring")])
def test_sharded_deflated_matches_unsharded(storage, comm, port_unsharded):
    """tests/test_sharding.py:116-140 on the port: same status and steps,
    true residuals within 1e-10; x gathered (d, n, t) on the lead device."""
    ref, res = port_unsharded(storage), _sharded(storage, comm)
    assert (res.status, res.niterations, res.checkpoints) == (ref.status, ref.niterations, ref.checkpoints)
    op, b = _op(), _b()
    assert res.x.factors.shape == ref.x.factors.shape and res.x.factors.device == torch.device("cpu")
    assert abs(tkt.kron_residual_dense(op, res.x, b) - tkt.kron_residual_dense(op, ref.x, b)) < TRUE_ATOL
    np.testing.assert_allclose(res.certified_bound, ref.certified_bound, rtol=BOUND_RTOL, atol=BOUND_ATOL)


def test_sharded_df64_matches_unsharded(port_unsharded):
    """tests/test_sharding.py:143-179 on the port: df64 with final='device'
    over the mesh, its bounds within rtol 1e-9 of the unsharded ones, the
    true residuals within 1e-10, the cross-checks within twice the larger
    floor; every relation term and the measured Gram present."""
    ref, res = port_unsharded("df64"), _sharded("df64")
    assert (res.status, res.niterations) == (ref.status, ref.niterations)
    np.testing.assert_allclose(res.certified_bound, ref.certified_bound, rtol=DF64_RTOL)
    op, b = _op(), _b()
    assert abs(tkt.kron_residual_dense(op, res.x, b) - tkt.kron_residual_dense(op, ref.x, b)) < TRUE_ATOL
    band = 2 * max(res.cp_residual_floor, ref.cp_residual_floor)
    assert abs(res.measured_cp_residual - ref.measured_cp_residual) <= band
    assert res.gram_source == "measured full Gram" and res.gram_deviation < 1e-13
    # η is modelled from T and the coefficients; dev records each commit's rounding, which the pieces' sums move
    np.testing.assert_allclose(res.relation_eta_term, ref.relation_eta_term, rtol=1e-6)
    np.testing.assert_allclose(res.relation_dev_term, ref.relation_dev_term, rtol=1e-2)


@pytest.mark.parametrize("storage, comm", [("twopass", "gspmd"), ("twopass", "ring"), ("full", "gspmd")])
def test_sharded_deflated_matches_jax(storage, comm, jax_unsharded):
    """The sharded port against the JAX package's unsharded solve at
    tests/test_torch_deflate.py's tolerances."""
    ref, res = jax_unsharded(storage), _sharded(storage, comm)
    assert (res.status, res.niterations, res.checkpoints, res.m, res.expsum_rank) == (
        int(ref.status), ref.niterations, ref.checkpoints, ref.m, ref.expsum_rank)
    np.testing.assert_allclose(res.certified_bound, ref.certified_bound, rtol=BOUND_RTOL, atol=BOUND_ATOL)
    np.testing.assert_allclose(res.relative_residual, ref.relative_residual, rtol=EST_RTOL, atol=EST_ATOL)
    np.testing.assert_allclose(res.x.factors.numpy(), np.asarray(ref.x.factors), rtol=0, atol=X_ATOL)
    np.testing.assert_allclose(res.x.weights.numpy(), np.asarray(ref.x.weights), rtol=1e-12)


def test_sharded_df64_matches_jax(jax_unsharded):
    """df64 over the mesh against the JAX package's unsharded df64 solve:
    tests/test_torch_df64.py's tolerances (bounds to 1e-10 up to the
    relation terms, estimates, x to 1e-10)."""
    ref, res = jax_unsharded("df64"), _sharded("df64")
    assert (res.status, res.niterations, res.checkpoints) == (int(ref.status), ref.niterations, ref.checkpoints)
    slack = max(*(r.relation_dev_term + r.relation_eta_term + r.relation_r2_term for r in (res, ref)))
    for a, r in zip(res.certified_bound, ref.certified_bound):
        assert abs(a - r) <= 1e-10 * r + slack, (a, r, slack)
    np.testing.assert_allclose(res.relative_residual, ref.relative_residual, rtol=1e-8, atol=EST_ATOL)
    np.testing.assert_allclose(res.x.factors.numpy(), np.asarray(ref.x.factors), rtol=0, atol=1e-10)


def test_sharded_distinct_factors_and_one_group():
    """Distinct factors (U (d, n, m), split over the factor groups) on the
    factor-parallel mesh, and a shared U on one row of 4 shards, 'full' and
    df64: each as the unsharded solve."""
    bands = _op().bands.clone()
    bands[1, 1] += 5.0
    op = tkt.KroneckerSumOperator(bands, (-1, 0, 1), True)
    b = torch.tensor(_b())
    for storage, mesh in (("full", _mesh()), ("df64", _mesh()),
                          ("full", make_mesh(devices=[torch.device("cpu")] * 4))):
        cfg = tkt.SolverConfig(**CONFIGS[storage])
        ref = tkt.solve_deflated(op, b, cfg, **_kw(storage))
        res = tkt.solve_deflated(op, b, cfg, mesh=mesh, **_kw(storage))
        assert (res.status, res.niterations) == (ref.status, ref.niterations)
        np.testing.assert_allclose(res.certified_bound, ref.certified_bound, rtol=DF64_RTOL)
        np.testing.assert_allclose(res.x.factors.numpy(), ref.x.factors.numpy(), rtol=0, atol=X_ATOL)


def test_sharded_state_caches_resume(tmp_path):
    """state_cache over the mesh holds whole vectors: a twopass solve
    stopped at k=8 resumes to the uninterrupted sharded result, and a df64
    cache written over the mesh resumes unsharded, bit for bit in T."""
    op, b = _op(), torch.tensor(_b())
    cfg = tkt.SolverConfig(kmax=16, tol=1e-12)
    full = tkt.solve_deflated(op, b, cfg, m=6, storage="twopass", mesh=_mesh(), checkpoints=[8, 16])
    cache = str(tmp_path / "tp.npz")
    tkt.solve_deflated(op, b, cfg, m=6, storage="twopass", mesh=_mesh(), checkpoints=[8], state_cache=cache)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = tkt.solve_deflated(op, b, cfg, m=6, storage="twopass", mesh=_mesh(), checkpoints=[8, 16],
                                 state_cache=cache)
    assert res.certified_bound == full.certified_bound
    np.testing.assert_allclose(res.x.factors.numpy(), full.x.factors.numpy(), rtol=0, atol=1e-14)

    dcache = str(tmp_path / "df64.npz")
    leg = tkt.solve_deflated(op, b, cfg, m=6, storage="df64", mesh=_mesh(), state_cache=dcache, advance_budget=8)
    assert leg.x is None and leg.niterations == 8
    done = tkt.solve_deflated(op, b, cfg, m=6, storage="df64", state_cache=dcache, final="device")
    ref = tkt.solve_deflated(op, b, cfg, m=6, storage="df64", mesh=_mesh(), final="device")
    assert done.status == ref.status and done.niterations == ref.niterations
    np.testing.assert_allclose(done.certified_bound, ref.certified_bound, rtol=DF64_RTOL)


def test_mesh_refusals():
    """As the JAX package (deflate.py:847-861, 906-907): df64 with
    comm='ring' raises naming 'gspmd'; 'segmented' and pass2_impl='host'
    refuse a mesh."""
    op, b, cfg, mesh = _op(), torch.tensor(_b()), tkt.SolverConfig(kmax=8), _mesh()
    with pytest.raises(ValueError, match="gspmd"):
        tkt.solve_deflated(op, b, cfg, m=6, storage="df64", mesh=mesh, comm="ring")
    with pytest.raises(ValueError, match="storage='segmented' does not support mesh yet"):
        tkt.solve_deflated(op, b, cfg, m=6, storage="segmented", mesh=mesh)
    with pytest.raises(ValueError, match="pass2_impl='host' requires storage='twopass' and no mesh"):
        tkt.solve_deflated(op, b, cfg, m=6, storage="twopass", mesh=mesh, pass2_impl="host")
    with pytest.raises(ValueError, match="comm must be"):
        tkt.solve_deflated(op, b, cfg, m=6, storage="twopass", mesh=mesh, comm="ppermute")


@pytest.mark.parametrize("gallery, fp", [("laplace", 1), ("conv_diff", 1), ("conv_diff", 2)])
def test_pair_spmv_on_halo_pieces_is_bit_equal(gallery, fp):
    """parallel/halo.triple_spmv_pairs_sharded on the gspmd pieces is
    torch.equal, component by component, to ops/expansion.triple_spmv_pairs
    on the whole row (conv_diff: offsets −1..2, a right halo of 2)."""
    op = getattr(tkt, gallery)(2, 64, device="cpu")
    mesh = make_mesh(devices=CPU8, factor_parallel=fp)
    sop = shard_operator(op, mesh, "gspmd")
    rng = np.random.default_rng(4)
    vh, vl = ex.pair_from_f64(torch.tensor(rng.standard_normal((2, 64))))
    whole = ex.triple_spmv_pairs(*ex.pair_from_f64(op.bands), op.offsets, vh, vl)
    parts = triple_spmv_pairs_sharded(sop, [ex.pair_from_f64(sh.op.bands) for sh in sop.shards],
                                      shard_rhs(vh, mesh), shard_rhs(vl, mesh))
    for i, name in enumerate(ex.Triple._fields):
        assert torch.equal(gather([p[i] for p in parts], mesh), whole[i]), name


def test_shard_basis_round_trips():
    """shard_basis splits U's n axis like shard_rhs splits b; a shared U
    goes to every factor group, a distinct one is split by group."""
    mesh = _mesh()
    U = torch.tensor(np.random.default_rng(1).standard_normal((2, 64, 3)))
    parts = shard_basis(U, mesh, 2)
    assert [tuple(p.shape) for p in parts] == [(1, 16, 3)] * 8
    assert torch.equal(gather(parts, mesh, axis=1), U)
    shared = shard_basis(U[:1], mesh, 2)
    assert [tuple(p.shape) for p in shared] == [(1, 16, 3)] * 8
    assert torch.equal(torch.cat(shared[:4], dim=1), U[0:1]) and torch.equal(torch.cat(shared[4:], dim=1), U[0:1])


# ---- the one-piece steps, bit for bit as before they took pieces ----


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.detach().cpu().numpy().astype(np.float64)).tobytes())
    return h.hexdigest()[:32]


def _rhs(d, n, seed):
    return torch.tensor(np.random.default_rng(seed).standard_normal((d, n)) + 0.5)


def _golden_lanczos(mode):
    op, b = tkt.laplace(3, 24, shift=7.0, device="cpu"), _rhs(3, 24, 11)
    reorth = {"plain": False, "always": True, "auto": "auto", "fused": False}[mode]
    st, bn = init_state(op, b, 12, F64)
    losses = []
    for k in range(1, 13):
        st, loss = lanczos_step(op, st, b, k, reorth=reorth, proj_dtype=F64, fused=mode == "fused",
                                reorth_tol=1e-16 if mode == "auto" else 0.0)
        losses.append(loss)
    return _digest(st.V, st.H, st.btil, st.beta, bn, torch.stack(losses))


def _golden_lucky():
    op, b = tkt.eigval_matrix(np.arange(1.0, 9.0), d=2, device="cpu"), torch.ones((2, 8), dtype=F64)
    st, _ = init_state(op, b, 9, F64)
    for k in range(1, 10):
        st, _ = lanczos_step(op, st, b, k, reorth=True, proj_dtype=F64)
    return _digest(st.V, st.H, st.btil, st.beta)


def _golden_arnoldi():
    op, b = tkt.conv_diff(3, 24, device="cpu"), _rhs(3, 24, 12)
    st, _ = init_state(op, b, 10, F64)
    losses = []
    for k in range(1, 11):
        st, loss = arnoldi_step(op, st, b, k, proj_dtype=F64)
        losses.append(loss)
    return _digest(st.V, st.H, st.btil, st.beta, torch.stack(losses))


def _deflated_problem(shared):
    op = tkt.laplace(3, 32, shift=3.0, device="cpu")
    if not shared:
        op = tkt.KroneckerSumOperator(op.bands * torch.tensor([1.0, 1.5, 2.0], dtype=F64)[:, None, None], op.offsets)
    U = torch.tensor(tkt.deflation_basis(op, 5).U)
    b = _rhs(3, 32, 13)
    return op, U, deflation_subtract(b, U, deflation_coeffs(b, U))


def _golden_lanczos_deflate():
    op, U, b_perp = _deflated_problem(True)
    st, _ = init_state(op, b_perp, 8, F64)
    for k in range(1, 9):
        st, _ = lanczos_step(op, st, b_perp, k, reorth=True, proj_dtype=F64, deflate_U=U)
    return _digest(st.V, st.H, st.btil, st.beta)


def _golden_deflated(case):
    op, U, b_perp = _deflated_problem(case != "distinct")
    K = 13
    st = deflate_light._init_state(b_perp, K)
    V = torch.zeros((K, 3, 32), dtype=F64)
    V[0] = st.vp
    kw = dict(always=dict(reorth="always"), auto=dict(reorth="auto", reorth_tol=1e-14),
              twopass=dict(measure_leak=True, project_every=2), distinct=dict(reorth="always"))[case]
    for k in range(1, K):
        V[k] = deflate_light._step(op, st, b_perp, U, k, V=V, **kw)
    out = [st.dg, st.od, st.btil, st.beta, st.leak, V]
    if case == "twopass":
        Yv = torch.tensor(np.random.default_rng(3).standard_normal((3, K, 4)))
        X, audit = deflate_light._pass2_accumulate(op, b_perp, U, st.od, Yv, K - 2, n_probes=4, project_every=2)
        out += [X, torch.tensor([audit.gram_max, audit.beta_rel_dev])]
    return _digest(*out)


def _golden_df64(project, sweep):
    op, U, b_perp = _deflated_problem(True)
    K = 9
    st, _, _ = df64_core._df64_init(b_perp.numpy(), K, U.shape[2], "cpu")
    Upair = df64_core.pair_value(U)
    bh, bl = ex.pair_from_f64(op.bands)
    for k in range(1, K):
        df64_core._df64_step(bh, bl, op.offsets, st, b_perp, Upair, k, project, sweep)
    return _digest(st.dg, st.od, st.btil, st.vp_h, st.vp_l, st.vq_h, st.vq_l, st.beta, st.leak,
                   st.sweep_overlap, st.V, st.W, st.C, st.dev)


GOLDENS = {
    "lanczos_plain": (lambda: _golden_lanczos("plain"), "8f301325c117f4832d33963104cf9443"),
    "lanczos_always": (lambda: _golden_lanczos("always"), "ac9a0b34fd5780d05325f58705a30a59"),
    "lanczos_auto": (lambda: _golden_lanczos("auto"), "93e937a0334bac9456ffe7b9aca71efd"),
    "lanczos_fused": (lambda: _golden_lanczos("fused"), "62c63010c626d06864ccb6fe6867069c"),
    "lucky": (_golden_lucky, "abd56a23fdc2c6299cb72adadc43df19"),
    "arnoldi": (_golden_arnoldi, "7df14f686ae42a72748dd04555d77b2c"),
    "lanczos_deflate": (_golden_lanczos_deflate, "b1e293cf1d4aea61ec69ebe32f22e604"),
    "deflated_always": (lambda: _golden_deflated("always"), "ac614bbd71b39fe53cf167d7ecaedc88"),
    "deflated_auto": (lambda: _golden_deflated("auto"), "4d1b8b14435adf916051ed0a2df2df60"),
    "deflated_twopass": (lambda: _golden_deflated("twopass"), "e8d62f4b7401007275985da109930781"),
    "deflated_distinct": (lambda: _golden_deflated("distinct"), "771f25f11f3f0a183d484944919fa436"),
    "df64_full": (lambda: _golden_df64(True, True), "a59c641b6785f0de98db066cc9a5412c"),
    "df64_noproject": (lambda: _golden_df64(False, True), "bcb12e533428bd07ebd322647fd54039"),
}


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_one_piece_step_is_unchanged(case):
    """The one-piece lanczos_step (plain, always, auto, fused, the lucky
    restart, deflate_U), arnoldi_step, deflate_light._step (and pass 2) and
    _df64_step from a seed: the digest of every output equals the digest of
    the same run before the steps were written over pieces."""
    run, digest = GOLDENS[case]
    assert run() == digest


@pytest.mark.parametrize("comm", ["gspmd", "ring"])
def test_deflated_step_over_pieces_agrees_with_one_piece(comm):
    """deflate_light._step over 8 pieces from the same start as the one-piece
    step: T and the vectors agree to rounding (the sums are summed in
    pieces), the sweep over a stored basis included."""
    op, U, b_perp = _deflated_problem(False)
    mesh = make_mesh(devices=CPU8, factor_parallel=1)
    sop = shard_operator(op, mesh, comm)
    K = 9
    st = deflate_light._init_state(b_perp, K)
    bp, Up = shard_rhs(b_perp, mesh), shard_basis(U, mesh, 3)
    sst = deflate_light._init_state(bp, K, sop)
    V = torch.zeros((K, 3, 32), dtype=F64)
    V[0] = st.vp
    Vp = [torch.zeros((K,) + tuple(x.shape), dtype=F64) for x in bp]
    for Vi, x in zip(Vp, sst.vp):
        Vi[0] = x
    deflate_light._advance(op, st, b_perp, U, 1, K, V=V, reorth="always", measure_leak=True)
    deflate_light._advance(sop, sst, bp, Up, 1, K, V=Vp, reorth="always", measure_leak=True)
    for f in ("dg", "od", "btil", "leak"):
        np.testing.assert_allclose(getattr(sst, f).numpy(), getattr(st, f).numpy(), rtol=1e-12, atol=1e-14,
                                   err_msg=f)
    np.testing.assert_allclose(gather(Vp, mesh, axis=-1, factor_axis=1).numpy(), V.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shared", [True, False])
def test_once_per_solve_charges_over_pieces(shared):
    """The df64 charges computed once per solve, over the gspmd pieces
    against the whole: the bands' pair rounding bit for bit (the slabs' row
    and column sums are the whole's, the maxima exact), the deflated block's
    defect A Ũ − Ũ Λ and b's split to rounding (their squares are summed in
    pieces). The bands are not exact in 48 bits, so every term is nonzero."""
    rng = np.random.default_rng(8)
    op0 = tkt.reaction_diffusion(2, 64, 1.0 / 3.0, device="cpu")
    scale = torch.tensor([1.0, 1.0] if shared else [1.0, 1.0 + 1.0 / 7.0], dtype=F64)
    op = tkt.KroneckerSumOperator(op0.bands * scale[:, None, None], op0.offsets)
    basis = tkt.deflation_basis(op, 6)
    mesh = _mesh()
    sop = shard_operator(op, mesh, "gspmd")
    U = torch.tensor(basis.U)
    Upair = df64_core.pair_value(U)
    eps, lam_g = df64_core._eft_eps("cpu"), np.array([4.0 * 65 ** 2 + 1.0] * 2)
    band = df64_core._band_rounding(op.bands.numpy(), op.offsets)
    assert band.min() > 0.0
    assert np.array_equal(df64_core._band_rounding([sh.op.bands.numpy() for sh in sop.shards], op.offsets, sop), band)
    whole = df64_core._deflation_residual(op.bands, op.offsets, Upair, basis.lam, eps, lam_g)
    parts = df64_core._deflation_residual([sh.op.bands for sh in sop.shards], op.offsets,
                                          shard_basis(Upair, mesh, 2), basis.lam, eps, lam_g, sop)
    np.testing.assert_allclose(parts, whole, rtol=1e-12)
    b = torch.tensor(rng.standard_normal((2, 64, 1)))
    c = deflation_coeffs(b[:, :, 0], U)[:, :, None]
    whole = df64_core._split_rounding(U, Upair, b, c)
    parts = df64_core._split_rounding(shard_basis(U, mesh, 2), shard_basis(Upair, mesh, 2),
                                      [x[:, :, None] for x in shard_rhs(b[:, :, 0], mesh)], c, sop, shared=shared)
    np.testing.assert_allclose(parts, whole, rtol=1e-12)
