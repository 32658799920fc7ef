"""Every solver of the port given a ShardedOperator, on shard slots of the
CPU: the sharded block and two-pass solves (the JAX dry run's
``solve_block(shard_operator(op, mesh), B_sharded, cfg)`` and
``solve_two_pass(shard_operator(op, mesh), shard_rhs(b, mesh), cfg)``),
solve_multi_rhs on a ('rhs', 'factor', 'mode') mesh, and one test per solver:
it runs and matches the unsharded solve, or raises its named error.

The meshes are make_mesh(devices=[cpu] * 8) with factor_parallel=2 (2 factor
groups of 4 mode shards) and factor_parallel=1 (8 mode shards), on both
comms; the kernels' plain versions run. The block cases are
tests/test_block.py's (the SPD one at n=32, which 4 and 8 mode shards
divide, with R=4 so that, as there, kmax is cut to the steps that fill the
space), the two-pass cases tests/test_twopass.py's (laplace at n=32). Each
sharded solve is held against the port's unsharded one and against the JAX
package's unsharded one (run once per module). The one-piece digests below
are sha256 digests of block_krylov_step's outputs and of the two-pass's
recorded α, β, b̃ and pass 2's X from a seed, recorded before the steps took
pieces: one piece must run the same operations, bit for bit."""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch import block, twopass
from tensorkrylov_tpu_torch.parallel import make_mesh, shard_operator, shard_rhs
from tensorkrylov_tpu_torch.parallel.sharding import gather, rhs_pieces
from tensorkrylov_tpu_torch.utils.cp import kron_apply_cp

# many small eigh calls: one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)

F64 = torch.float64
CPU8 = [torch.device("cpu")] * 8
MESHES = {"fp2": 2, "fp1": 1}   # factor_parallel of the 8 CPU slots
SETUPS = [(m, c) for m in MESHES for c in ("gspmd", "ring")]
# sharded against unsharded block solves (CGS2): estimates to 1e-8 relative, x to 1e-10 absolute
BLOCK_EST_RTOL, BLOCK_X_ATOL = 1e-8, 1e-10
# against the JAX package's unsharded block solve: tests/test_torch_block.py's tolerances
JAX_BLOCK_RTOL, JAX_BLOCK_FULL_RTOL = 1e-10, 1e-9
# the nonsymmetric case's estimates sit at the cancellation floor (64·eps·scale), where a rounding of eps·scale
# moves them by 1/64 (tests/test_torch_block.py): so against either reference
FLOOR_RTOL = 1.0 / 64
# plain (unreorthogonalized) Lanczos in another sum order: steps within ±1 (the JAX dry run's rule), the
# estimates at the common checks and x (relative to max|x|) within 1e-6; the estimates beside 1e-12 absolute,
# tests/test_torch_twopass.py's: on the distinct spectra the last ones sit near 5e-9 at ~1e-13 of ‖b‖ apart
TWO_PASS_RTOL, TWO_PASS_ATOL, TWO_PASS_STEPS = 1e-6, 1e-12, 1
# solve and its siblings over a mesh with reorthogonalization: traces to 1e-8 relative, x to 1e-10
TRACE_RTOL, X_ATOL = 1e-8, 1e-10
# solve_multi_rhs on the 3-D mesh: tests/test_torch_multi_rhs.py's trace tolerance
MULTI_RTOL = 1e-10


def _mesh(name):
    return make_mesh(devices=CPU8, factor_parallel=MESHES[name])


def _sop(op, setup):
    mesh_name, comm = setup
    return shard_operator(op, _mesh(mesh_name), comm)


def _unit_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---- the sharded block solve ----

# name: (gallery, d, n, R, seed, config fields): tests/test_block.py's cases
BLOCK = {
    "spd": ("laplace", 2, 32, 4, 5, dict(kmax=18, tol=1e-9, check_every=1)),
    "nonsym": ("conv_diff", 2, 24, 2, 6, dict(kmax=12, tol=1e-6, orth="arnoldi", tmax=151, check_every=1)),
    "duplicate_rhs": ("laplace", 2, 24, 2, 7, dict(kmax=12, tol=1e-9, check_every=1)),
}


def _block_case(name):
    gal, d, n, R, seed, fields = BLOCK[name]
    B = _unit_rows(np.random.default_rng(seed).standard_normal((R, d, n)))
    if name == "duplicate_rhs":  # linearly dependent columns: the lucky restart runs over pieces
        B = np.stack([B[0], B[0]])
    return gal, getattr(tkt, gal)(d, n, device="cpu"), B, fields


@pytest.fixture(scope="module")
def block_refs():
    cache = {}

    def run(name, pkg):
        if (name, pkg) not in cache:
            gal, op, B, fields = _block_case(name)
            if pkg == "jax":
                cache[name, pkg] = tk.solve_block(getattr(tk, gal)(op.d, op.n), B, tk.SolverConfig(**fields))
            else:
                cache[name, pkg] = tkt.solve_block(op, torch.tensor(B), tkt.SolverConfig(**fields))
        return cache[name, pkg]

    return run


def _sharded_block(name, setup):
    _, op, B, fields = _block_case(name)
    sop = _sop(op, setup)
    return tkt.solve_block(sop, shard_rhs(B, sop.mesh, op.d), tkt.SolverConfig(**fields))


@pytest.mark.parametrize("name", sorted(BLOCK))
@pytest.mark.parametrize("setup", SETUPS, ids=[f"{m}-{c}" for m, c in SETUPS])
def test_sharded_block_matches_unsharded(name, setup, block_refs):
    """The same status and block steps, the estimates within 1e-8 relative
    (the nonsymmetric ones, at the cancellation floor, within 1/64),
    x within 1e-10, gathered (d, n, tmax·R) on the lead slot, and the
    weights (from the projected spectrum) within 1e-12."""
    ref, res = block_refs(name, "port"), _sharded_block(name, setup)
    k = res.niterations
    assert (res.status, k) == (ref.status, ref.niterations) and res.status == tkt.Status.CONVERGED
    checked = np.isfinite(ref.relative_residual.numpy())
    np.testing.assert_allclose(res.relative_residual.numpy()[checked], ref.relative_residual.numpy()[checked],
                               rtol=FLOOR_RTOL if name == "nonsym" else BLOCK_EST_RTOL)
    assert res.x.factors.shape == ref.x.factors.shape and res.x.factors.device == torch.device("cpu")
    np.testing.assert_allclose(res.x.factors.numpy(), ref.x.factors.numpy(), rtol=0, atol=BLOCK_X_ATOL)
    np.testing.assert_allclose(res.x.weights.numpy(), ref.x.weights.numpy(), rtol=1e-12)


@pytest.mark.parametrize("name", sorted(BLOCK))
@pytest.mark.parametrize("comm", ["gspmd", "ring"])
def test_sharded_block_matches_jax(name, comm, block_refs):
    """Over 2 factor groups × 4 mode shards against the JAX package's
    unsharded solve_block at tests/test_torch_block.py's tolerances."""
    ref, res = block_refs(name, "jax"), _sharded_block(name, ("fp2", comm))
    assert (res.status, res.niterations) == (int(ref.status), int(ref.niterations))
    checked = np.isfinite(np.asarray(ref.relative_residual))
    for f in ("relative_residual", "lambda_min", "lambda_max"):
        rtol = FLOOR_RTOL if (name, f) == ("nonsym", "relative_residual") else JAX_BLOCK_RTOL
        np.testing.assert_allclose(getattr(res, f).numpy()[checked], np.asarray(getattr(ref, f))[checked],
                                   rtol=rtol, err_msg=f)
    np.testing.assert_array_equal(res.expsum_rank.numpy(), np.asarray(ref.expsum_rank))
    full, jfull = tkt.cp_full(res.x), np.asarray(tk.cp_full(ref.x))
    assert np.abs(full - jfull).max() <= JAX_BLOCK_FULL_RTOL * np.abs(jfull).max()


def test_sharded_block_takes_whole_B_and_counts_one_spmv_per_step(monkeypatch):
    """B whole (split by solve_block) gives the pieces' result bit for bit;
    each block step is one sharded SpMV of (d_f, R, n_local) per shard."""
    from tensorkrylov_tpu_torch.parallel import krylov

    _, op, B, fields = _block_case("spd")
    sop = _sop(op, ("fp2", "gspmd"))
    calls = []
    real = krylov.spmv_sharded
    monkeypatch.setattr(krylov, "spmv_sharded", lambda s, vs: calls.append([tuple(v.shape) for v in vs]) or real(s, vs))
    res = tkt.solve_block(sop, torch.tensor(B), tkt.SolverConfig(**fields))
    assert len(calls) == res.niterations and calls[0] == [(1, 4, 8)] * 8
    monkeypatch.undo()
    again = tkt.solve_block(sop, shard_rhs(B, sop.mesh, 2), tkt.SolverConfig(**fields))
    assert torch.equal(res.x.factors, again.x.factors) and torch.equal(res.relative_residual, again.relative_residual)


# ---- the sharded two-pass solve ----

# name: (operator factory (JAX, port), d, n, seed, identical rows, config fields): tests/test_twopass.py's cases
TWO_PASS = {
    "laplace": (lambda m, **kw: m.laplace(3, 32, **kw), 3, 32, 7, True, dict(kmax=32, tol=1e-8, orth="lanczos")),
    "check_every": (lambda m, **kw: m.laplace(3, 32, **kw), 3, 32, 5, True,
                    dict(kmax=32, tol=1e-8, orth="lanczos", check_every=4)),
    "distinct": (lambda m, **kw: m.eigval_matrix(np.stack([np.linspace(1.0, 40.0, 24), np.linspace(2.0, 55.0, 24)]),
                                                 **kw), 2, 24, 10, False, dict(kmax=24, tol=1e-8, orth="lanczos")),
}


def _two_pass_case(name):
    make, d, n, seed, identical, fields = TWO_PASS[name]
    b = tk.random_rhs(d, n, seed=seed, identical=identical)
    return make, make(tkt, device="cpu"), np.array(b / jnp.linalg.norm(b, axis=1, keepdims=True)), fields


@pytest.fixture(scope="module")
def two_pass_refs():
    cache = {}

    def run(name, pkg):
        if (name, pkg) not in cache:
            make, op, b, fields = _two_pass_case(name)
            if pkg == "jax":
                cache[name, pkg] = tk.solve_two_pass(make(tk), b, tk.SolverConfig(**fields))
            else:
                cache[name, pkg] = tkt.solve_two_pass(op, torch.tensor(b), tkt.SolverConfig(**fields))
        return cache[name, pkg]

    return run


def _two_pass_close(res, ref):
    """Steps within ±1 and the same status; the estimates at the checks both
    made, and x relative to max|x|, within TWO_PASS_RTOL."""
    k, kr = res.niterations, int(ref.niterations)
    assert res.status == int(ref.status) == tkt.Status.CONVERGED and abs(k - kr) <= TWO_PASS_STEPS
    est, want = res.relative_residual.numpy(), np.asarray(ref.relative_residual)
    both = np.isfinite(est) & np.isfinite(want)
    np.testing.assert_allclose(est[both], want[both], rtol=TWO_PASS_RTOL, atol=TWO_PASS_ATOL)
    x, xr = res.x.factors.numpy(), np.asarray(ref.x.factors)
    assert np.abs(x - xr).max() <= TWO_PASS_RTOL * np.abs(xr).max()
    np.testing.assert_allclose(res.x.weights.numpy(), np.asarray(ref.x.weights), rtol=TWO_PASS_RTOL)


def _sharded_two_pass(name, setup):
    _, op, b, fields = _two_pass_case(name)
    sop = _sop(op, setup)
    return tkt.solve_two_pass(sop, shard_rhs(b, sop.mesh, op.d), tkt.SolverConfig(**fields))


@pytest.mark.parametrize("name", sorted(TWO_PASS))
@pytest.mark.parametrize("setup", SETUPS, ids=[f"{m}-{c}" for m, c in SETUPS])
def test_sharded_two_pass_matches_unsharded(name, setup, two_pass_refs):
    res = _sharded_two_pass(name, setup)
    _two_pass_close(res, two_pass_refs(name, "port"))
    assert res.x.factors.device == torch.device("cpu") and res.config.step_impl == "xla"


@pytest.mark.parametrize("name", sorted(TWO_PASS))
@pytest.mark.parametrize("comm", ["gspmd", "ring"])
def test_sharded_two_pass_matches_jax(name, comm, two_pass_refs):
    _two_pass_close(_sharded_two_pass(name, ("fp2", comm)), two_pass_refs(name, "jax"))


def test_sharded_two_pass_spmv_counts(monkeypatch):
    """One sharded SpMV per step of each pass: 2k in all."""
    from tensorkrylov_tpu_torch.parallel import krylov

    calls = []
    real = krylov.spmv_sharded
    monkeypatch.setattr(krylov, "spmv_sharded", lambda s, vs: calls.append(len(vs)) or real(s, vs))
    res = _sharded_two_pass("laplace", ("fp1", "ring"))
    assert calls == [8] * (2 * res.niterations)


# ---- the one-piece steps, bit for bit as before they took pieces ----


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.detach().cpu().numpy().astype(np.float64)).tobytes())
    return h.hexdigest()[:32]


def _golden_block(case):
    op = {"spd": lambda: tkt.laplace(2, 24, device="cpu"), "duplicate": lambda: tkt.laplace(2, 24, device="cpu"),
          "nonsym": lambda: tkt.conv_diff(2, 24, device="cpu"),
          "f32": lambda: tkt.laplace(3, 16, shift=2.0, device="cpu")}[case]()
    R = 3 if case == "spd" else 2
    B = np.random.default_rng(21).standard_normal((R, op.d, op.n))
    if case == "duplicate":
        B[1:] = B[0]
    B = torch.tensor(_unit_rows(B))
    st, bn = block.init_block_state(op, B, 6, R, F64, torch.float32 if case == "f32" else None)
    for k in range(1, 7):
        st = block.block_krylov_step(op, st, B, k, R, proj_dtype=F64)
    return _digest(st.V, st.H, st.btil, st.beta, bn)


def _golden_two_pass(case):
    if case == "lucky":
        op, b, K = tkt.eigval_matrix(np.arange(1.0, 9.0), d=2, device="cpu"), torch.ones((2, 8), dtype=F64), 10
    else:
        op = tkt.reaction_diffusion(3, 24, 0.5, device="cpu")
        b, K = torch.tensor(np.random.default_rng(22).standard_normal((3, 24)) + 0.5), 13
    st = twopass._start(b, F64, F64)
    vp, vpp, beta = st.v0, torch.zeros_like(st.v0), torch.zeros((op.d,), dtype=F64)
    H = torch.zeros((op.d, K + 1, K + 1), dtype=F64)
    out = [st.v0, st.b_norms, st.bt0]
    for k in range(1, K + 1):
        v_new, alpha, beta_new, bt = twopass._recurrence_step(op, vp, vpp, beta, st.b, F64, case == "fused")
        H[:, k - 1, k - 1] = alpha
        H[:, k, k - 1] = H[:, k - 1, k] = beta_new
        out += [alpha, beta_new, bt]
        vp, vpp, beta = v_new, vp, beta_new
    Y = torch.tensor(np.random.default_rng(23).standard_normal((op.d, K + 1, 4)))
    X = twopass._lift_pass2(op, twopass._start(b, F64, F64), H, Y, K - 1, F64)
    return _digest(*out), _digest(X)


GOLDENS = {
    "block_spd": (lambda: _golden_block("spd"), "813824221eef0071556add9caf6ee5a2"),
    "block_duplicate": (lambda: _golden_block("duplicate"), "2f7f313061d55dc2fd52489f0b063322"),
    "block_nonsym": (lambda: _golden_block("nonsym"), "138bfc94ed47656e4b3162de58a0691c"),
    "block_f32": (lambda: _golden_block("f32"), "2858aa0ae1e18a168262c8f4d2af610b"),
    "two_pass_plain": (lambda: _golden_two_pass("plain"),
                       ("32898419970c5d4a4bc4e365185a5290", "be3e837b336e249d7e21667869fe8566")),
    "two_pass_fused": (lambda: _golden_two_pass("fused"),
                       ("97f610ea04f7a7cff1d5c5c644c577cb", "7a4d4ea0871489b4518669f9c62081cd")),
    "two_pass_lucky": (lambda: _golden_two_pass("lucky"),
                       ("5acb0387e180cedd73d50216f8332126", "f0072c7071eb84c19cec2b35dd3c31bb")),
}


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_one_piece_step_is_unchanged(case):
    """block_krylov_step with init_block_state (SPD, the lucky restart of
    duplicate columns, nonsymmetric, an f32 basis) and the two-pass's
    recurrence (its α, β, b̃; unfused, fused, through a lucky breakdown) and
    pass 2's X from a seed: the digests equal those of the same runs before
    the steps were written over pieces."""
    run, digest = GOLDENS[case]
    assert run() == digest


def test_block_step_over_pieces_agrees_with_one_piece():
    """block_krylov_step over 8 pieces from the same start as the one-piece
    step: H, b̃ and V to rounding (the sums are summed in pieces), the lucky
    restart of a duplicate column included."""
    op = tkt.laplace(2, 24, device="cpu")
    B = np.random.default_rng(21).standard_normal((2, 2, 24))
    B[1] = B[0]
    B = torch.tensor(_unit_rows(B))
    mesh = _mesh("fp2")
    sop = shard_operator(op, mesh, "ring")
    st, bn = block.init_block_state(op, B, 6, 2, F64)
    sst, sbn = block.init_block_state(sop, shard_rhs(B, mesh, 2), 6, 2, F64)
    for k in range(1, 7):
        st = block.block_krylov_step(op, st, B, k, 2, proj_dtype=F64)
        sst = block.block_krylov_step(sop, sst, shard_rhs(B, mesh, 2), k, 2, proj_dtype=F64)
    np.testing.assert_allclose(float(sbn), float(bn), rtol=1e-14)
    np.testing.assert_allclose(sst.H.numpy(), st.H.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sst.btil.numpy(), st.btil.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(gather(sst.V, mesh, axis=-1, factor_axis=1).numpy(), st.V.numpy(), rtol=0, atol=1e-12)


# ---- shard_rhs of a block, the operator's recast and leading columns ----


@pytest.mark.parametrize("R", [3, 4])
def test_shard_rhs_of_a_block_splits_factor_axis_1(R):
    """shard_rhs(B, mesh, d) of a block (R, d, n) with factor_parallel=2,
    R ≠ d and R = d: piece g·P + p is B[:, d-group g, mode slice p], against
    slicing by hand; gathered back, B."""
    mesh = _mesh("fp2")
    B = torch.tensor(np.random.default_rng(3).standard_normal((R, 4, 32)))
    ps = shard_rhs(B, mesh, 4)
    want = [B[:, 2 * g:2 * g + 2, 8 * p:8 * p + 8] for g in range(2) for p in range(4)]
    assert len(ps) == 8 and all(torch.equal(a, w) and a.is_contiguous() for a, w in zip(ps, want))
    assert torch.equal(gather(ps, mesh, axis=-1, factor_axis=1), B)


def test_shard_rhs_of_a_stack_keeps_factor_axis_0():
    """A (d, m, n) stack splits its axis 0: without d, or with factor_axis=0
    where m = d."""
    mesh = _mesh("fp2")
    V = torch.tensor(np.random.default_rng(4).standard_normal((4, 3, 32)))
    grid = [(g, p) for g in range(2) for p in range(4)]
    assert all(torch.equal(a, V[2 * g:2 * g + 2, :, 8 * p:8 * p + 8]) for a, (g, p) in zip(shard_rhs(V, mesh), grid))
    sq = torch.tensor(np.random.default_rng(5).standard_normal((4, 4, 32)))
    assert all(torch.equal(a, sq[2 * g:2 * g + 2, :, 8 * p:8 * p + 8])
               for a, (g, p) in zip(shard_rhs(sq, mesh, 4, factor_axis=0), grid))


def test_rhs_pieces_checks_the_pieces():
    """Pieces cut for another split raise, naming the shapes and the call
    that splits a block; pieces of the right split pass as they are."""
    op = tkt.laplace(4, 32, device="cpu")
    mesh = _mesh("fp2")
    sop = shard_operator(op, mesh)
    B = torch.tensor(np.random.default_rng(6).standard_normal((3, 4, 32)))
    with pytest.raises(ValueError, match=r"shard_rhs\(B, mesh, d\)"):
        rhs_pieces(sop, shard_rhs(B, mesh), block=True)
    with pytest.raises(ValueError, match=r"b must be \(d, n\)"):
        rhs_pieces(sop, torch.zeros((4, 30), dtype=F64))
    ps = shard_rhs(B, mesh, 4)
    assert all(a is w for a, w in zip(rhs_pieces(sop, ps, block=True), ps))


@pytest.mark.parametrize("comm", ["gspmd", "ring"])
def test_sharded_operator_astype_and_leading_bands(comm):
    """astype recasts every shard as sharding the recast operator does;
    leading_bands gives the whole operator's leading columns from the shards."""
    op = tkt.reaction_diffusion(4, 32, 0.7, device="cpu")
    mesh = _mesh("fp2")
    sop = shard_operator(op, mesh, comm)
    s32, ref = sop.astype(torch.float32), shard_operator(op.astype(torch.float32), mesh, comm)
    assert sop.astype(F64) is sop and s32.dtype == torch.float32 and s32.comm == comm
    assert all(torch.equal(a.op.bands, b.op.bands) and a.cols == b.cols for a, b in zip(s32.shards, ref.shards))
    for cols in (3, 8, 13, 32):
        assert torch.equal(sop.leading_bands(cols), op.bands[:, :, :cols])


def test_kron_apply_cp_over_pieces():
    """kron_apply_cp with a ShardedOperator: the (d, t, n) SpMV over pieces,
    the result the unsharded one to rounding (the ring route adds the edge
    corrections after the interior)."""
    op = tkt.laplace(4, 32, device="cpu")
    rng = np.random.default_rng(7)
    x = tkt.CPTensor(torch.tensor(rng.standard_normal(5)), torch.tensor(rng.standard_normal((4, 32, 5))))
    ref = kron_apply_cp(op, x)
    for setup in SETUPS:
        got = kron_apply_cp(_sop(op, setup), x)
        assert torch.equal(got.weights, ref.weights)
        np.testing.assert_allclose(got.factors.numpy(), ref.factors.numpy(), rtol=0,
                                   atol=1e-15 * float(ref.factors.abs().max()))


# ---- solve_multi_rhs over a mesh ----


def _multi_problem():
    """The dry run's 3-D case: d=2, R=2, n=32, B uniform from a seed."""
    return tkt.laplace(2, 32, device="cpu"), np.random.default_rng(0).uniform(size=(2, 2, 32))


MULTI_CFG = dict(kmax=32, tol=1e-8)


@pytest.fixture(scope="module")
def multi_3d():
    op, B = _multi_problem()
    mesh3 = make_mesh(devices=CPU8, factor_parallel=2, rhs_parallel=2)
    return tkt.solve_multi_rhs(op, torch.tensor(B), tkt.SolverConfig(**MULTI_CFG), mesh=mesh3)


def test_multi_rhs_3d_mesh_lanes_match_unsharded(multi_3d):
    """Each lane of the (rhs=2, factor=2, mode=2) mesh against its unsharded
    rank-1 solve: the same status and steps, the traces within 1e-10."""
    op, B = _multi_problem()
    x, res = multi_3d
    assert res.status.shape == (2,) and x.factors.shape == (2, 32, 2 * res.config.tmax)
    for r in range(2):
        one = tkt.solve(op, torch.tensor(B[r]), tkt.SolverConfig(**MULTI_CFG))
        assert (int(res.status[r]), int(res.niterations[r])) == (one.status, one.niterations)
        for f in ("relative_residual", "lambda_min", "lambda_max"):
            a, w = getattr(res, f)[r].numpy(), getattr(one, f).numpy()
            ok = np.isfinite(w)
            np.testing.assert_allclose(a[ok], w[ok], rtol=MULTI_RTOL, err_msg=f)


def test_multi_rhs_3d_mesh_matches_jax(multi_3d):
    op, B = _multi_problem()
    jx, jres = tk.solve_multi_rhs(tk.laplace(2, 32), B, tk.SolverConfig(**MULTI_CFG))
    x, res = multi_3d
    np.testing.assert_array_equal(res.status.numpy(), np.asarray(jres.status))
    np.testing.assert_array_equal(res.niterations.numpy(), np.asarray(jres.niterations))
    for f in ("relative_residual", "projected_residual", "lambda_min", "lambda_max"):
        a, w = getattr(res, f).numpy(), np.asarray(getattr(jres, f))
        ok = np.isfinite(w)
        np.testing.assert_allclose(a[ok], w[ok], rtol=MULTI_RTOL, err_msg=f)
    full, ref = tkt.cp_full(x), np.asarray(tk.cp_full(jx))
    assert float(np.abs(full - ref).max()) <= 1e-10 * float(np.abs(ref).max())


def test_multi_rhs_over_a_2d_mesh_and_a_sharded_operator():
    """A 2-D mesh, and a ShardedOperator with B whole or its pieces, run the
    R lanes in turn over that mesh: the same result each way."""
    op, B = _multi_problem()
    cfg = tkt.SolverConfig(**MULTI_CFG)
    mesh = _mesh("fp2")
    _, a = tkt.solve_multi_rhs(op, torch.tensor(B), cfg, mesh=mesh, comm="ring")
    sop = shard_operator(op, mesh, "ring")
    _, b = tkt.solve_multi_rhs(sop, torch.tensor(B), cfg)
    _, c = tkt.solve_multi_rhs(sop, shard_rhs(B, mesh, 2), cfg)
    for f in ("status", "niterations", "relative_residual", "lambda_min"):
        assert torch.equal(getattr(a, f), getattr(b, f)) and torch.equal(getattr(b, f), getattr(c, f)), f
    assert torch.equal(a.x.factors, c.x.factors)


def test_multi_rhs_rhs_groups_must_divide_R():
    op, B = _multi_problem()
    mesh3 = make_mesh(devices=CPU8, factor_parallel=2, rhs_parallel=2)
    with pytest.raises(ValueError, match="rhs groups"):
        tkt.solve_multi_rhs(op, torch.tensor(np.concatenate([B, B[:1]])), tkt.SolverConfig(**MULTI_CFG), mesh=mesh3)
    with pytest.raises(ValueError, match="not both"):
        tkt.solve_multi_rhs(shard_operator(op, mesh3.rhs_groups()[0]), torch.tensor(B), mesh=mesh3)
    # an operator splits over one rhs group's grid, not the 3-D mesh
    with pytest.raises(ValueError, match="rhs groups"):
        shard_operator(op, mesh3)


def test_make_mesh_rhs_groups():
    mesh3 = make_mesh(devices=CPU8, factor_parallel=2, rhs_parallel=2)
    assert mesh3.shape == {"rhs": 2, "factor": 2, "mode": 2} and mesh3.axis_names == ("rhs", "factor", "mode")
    assert [g.shape for g in mesh3.rhs_groups()] == [{"factor": 2, "mode": 2}] * 2
    assert _mesh("fp2").rhs_groups() == (_mesh("fp2"),)
    with pytest.raises(ValueError, match="rhs_parallel=3"):
        make_mesh(devices=CPU8, rhs_parallel=3)


# ---- every solver given a ShardedOperator: it runs and matches, or raises its named error ----


def _problem():
    """The case of ROADMAP.md Queue 3's fixed fault: laplace(4, 32), a unit-row b, over 2 factor groups
    of 4 mode shards."""
    op = tkt.laplace(4, 32, device="cpu")
    b = tkt.random_rhs(4, 32, seed=3)
    return op, b / torch.linalg.vector_norm(b, dim=1, keepdim=True)


def _close(res, ref):
    k = res.niterations
    assert (res.status, k) == (ref.status, ref.niterations) and res.status == tkt.Status.CONVERGED
    ok = np.isfinite(ref.relative_residual.numpy())
    np.testing.assert_allclose(res.relative_residual.numpy()[ok], ref.relative_residual.numpy()[ok], rtol=TRACE_RTOL)
    np.testing.assert_allclose(res.x.factors.numpy(), ref.x.factors.numpy(), rtol=0, atol=X_ATOL)


@pytest.mark.parametrize("comm", ["gspmd", "ring"])
@pytest.mark.parametrize("pieces", [False, True], ids=["b_whole", "b_pieces"])
def test_solve_takes_a_sharded_operator(comm, pieces):
    """solve(sop, b), the JAX package's solve_sharded call, with b whole or its
    pieces: the unsharded solve's status, steps, traces and x; equal bit for
    bit to solve_sharded."""
    from tensorkrylov_tpu_torch.parallel import solve_sharded

    op, b = _problem()
    cfg = tkt.SolverConfig(kmax=32, tol=1e-8)
    sop = _sop(op, ("fp2", comm))
    res = tkt.solve(sop, shard_rhs(b, sop.mesh) if pieces else b, cfg)
    _close(res, tkt.solve(op, b, cfg))
    ref = solve_sharded(op, b, cfg, _mesh("fp2"), comm)
    assert torch.equal(res.x.factors, ref.x.factors) and torch.equal(res.relative_residual, ref.relative_residual)


def test_solve_over_a_mesh_takes_A_minor():
    """spectral_source='A_minor' takes the leading columns from the shards."""
    op, b = _problem()
    cfg = tkt.SolverConfig(kmax=32, tol=1e-8, spectral_source="A_minor")
    _close(tkt.solve(_sop(op, ("fp2", "ring")), b, cfg), tkt.solve(op, b, cfg))


def test_solve_resumable_over_a_mesh(tmp_path):
    """Chunked, checkpointed (the basis as its pieces) and resumed over a
    mesh: bit for bit the sharded solve."""
    op, b = _problem()
    cfg = tkt.SolverConfig(kmax=32, tol=1e-8)
    sop = _sop(op, ("fp2", "gspmd"))
    ref = tkt.solve(sop, b, cfg)
    path = str(tmp_path / "carry.pt")
    seg = tkt.solve_resumable(sop, b, cfg, chunk=7, checkpoint_path=path)
    res = tkt.solve_resumable(sop, b, cfg, chunk=7, checkpoint_path=path, resume=True)
    for r in (seg, res):
        assert (r.status, r.niterations) == (ref.status, ref.niterations)
        assert torch.equal(r.x.factors, ref.x.factors) and torch.equal(r.relative_residual, ref.relative_residual)


def test_solve_host_projected_takes_a_sharded_operator():
    """The unfused step over pieces ('auto' resolves to 'xla'), the
    projected stage on the host, x gathered."""
    op, b = _problem()
    cfg = tkt.SolverConfig(kmax=32, tol=1e-8)
    res = tkt.solve_host_projected(_sop(op, ("fp2", "ring")), b, cfg)
    _close(res, tkt.solve_host_projected(op, b, cfg))
    assert res.config.step_impl == "xla"


def test_solve_refined_takes_a_sharded_operator():
    """tests/test_refine.py's beats_single_shot case over 8 mode shards: the
    first cycle (the rank-1 solve over the mesh and its CP residual through
    the sharded SpMV) to 1e-10; converged below tol by the dense oracle. The
    later cycles round a cancelling residual (tests/test_torch_refine.py), so
    they are compared by their outcome."""
    b = tk.random_rhs(3, 32, seed=3)
    b = torch.tensor(np.asarray(b / jnp.linalg.norm(b, axis=1, keepdims=True)))
    op = tkt.laplace(3, 32, device="cpu")
    cfg, kw = tkt.SolverConfig(kmax=10, tol=1e-5), dict(max_restarts=5, residual_rank=4, inner_tol=1e-4)
    ref = tkt.solve_refined(op, b, cfg, **kw)
    res = tkt.solve_refined(_sop(op, ("fp1", "gspmd")), b, cfg, **kw)
    np.testing.assert_allclose(res.residual_history[0], ref.residual_history[0], rtol=1e-10)
    assert res.inner_iterations[0] == ref.inner_iterations[0]
    assert res.converged and ref.converged and tkt.kron_residual_dense(op, res.x, b) < cfg.tol


def test_unported_forms_raise_their_named_errors():
    """What a ShardedOperator cannot take raises, naming why and what to
    call: solve_deflated without mesh=, solve_block_recorded (no mesh in
    the JAX package either), an explicit 'fused' step in solve,
    solve_two_pass and solve_block, 'resident' in solve_host_projected."""
    op, b = _problem()
    sop = _sop(op, ("fp2", "ring"))
    B = torch.stack([b, 0.5 * b + 0.1])
    with pytest.raises(ValueError, match=r"solve_deflated\(op, b, mesh=sop.mesh, comm=sop.comm\)"):
        tkt.solve_deflated(sop, b, tkt.SolverConfig(kmax=6), m=4)
    with pytest.raises(NotImplementedError, match="VERDICT r5"):
        tkt.solve_block_recorded(sop, B, tkt.SolverConfig(kmax=4))
    for call in (lambda c: tkt.solve(sop, b, c), lambda c: tkt.solve_two_pass(sop, b, c),
                 lambda c: tkt.solve_block(sop, B, c)):
        with pytest.raises(ValueError, match="step_impl='fused' runs on one piece"):
            call(tkt.SolverConfig(kmax=8, orth="lanczos", step_impl="fused"))
    with pytest.raises(ValueError, match="step_impl='resident' runs on one piece"):
        tkt.solve_host_projected(sop, b, tkt.SolverConfig(kmax=8, orth="lanczos", basis_dtype=torch.float32,
                                                          step_impl="resident"))


def test_queue3_calls_run_or_raise_named():
    """Every call of that fault's table (ROADMAP.md Queue 3): none fails with AttributeError."""
    op, b = _problem()
    mesh = _mesh("fp2")
    sop = shard_operator(op, mesh)
    B = torch.stack([b, 0.5 * b + 0.1])
    cfg = tkt.SolverConfig(kmax=8, tol=1e-3)
    calls = {
        "solve": lambda: tkt.solve(sop, b, cfg),
        "solve_refined": lambda: tkt.solve_refined(sop, b, cfg, max_restarts=1),
        "solve_multi_rhs": lambda: tkt.solve_multi_rhs(sop, B, cfg),
        "solve_host_projected": lambda: tkt.solve_host_projected(sop, b, cfg),
        "solve_resumable": lambda: tkt.solve_resumable(sop, b, cfg, chunk=3),
        "solve_block": lambda: tkt.solve_block(sop, B, tkt.SolverConfig(kmax=4, tol=1e-3)),
        "solve_two_pass": lambda: tkt.solve_two_pass(sop, shard_rhs(b, mesh), tkt.SolverConfig(kmax=8, orth="lanczos")),
    }
    for name, call in calls.items():
        call()
    for call in (lambda: tkt.solve_deflated(sop, b, cfg, m=4), lambda: tkt.solve_block_recorded(sop, B, cfg)):
        with pytest.raises((ValueError, NotImplementedError)):
            call()


def test_dryrun_multichip_on_cpu_slots():
    """Every call of the JAX package's dryrun_multichip through the port on 8
    CPU slots: the (2, 4) mesh and the (2, 2, 2) mesh, each call's own checks."""
    from tensorkrylov_tpu_torch.experiments import dryrun_multichip

    out = dryrun_multichip.run(CPU8)
    assert out["mesh"] == {"factor": 2, "mode": 4} and out["n"] == 64
    assert out["multi_rhs_3d"]["mesh"] == {"rhs": 2, "factor": 2, "mode": 2}
    assert len(out["multi_rhs_3d"]["status"]) == 2
