"""ops/hess_eig's plain version (the CUDA kernel's twin) against
torch.linalg.eig on the CPU, the nonsymmetric check's solve through it, and
which paths keep torch.linalg.eig. The kernel itself is held to the twin in
tests/test_torch_cuda.py."""
import functools

import numpy as np
import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch import block, solver
from tensorkrylov_tpu_torch.coeffs.tables import select_stenger
from tensorkrylov_tpu_torch.ops import expsum
from tensorkrylov_tpu_torch.ops.hess_eig import hess_eig, hess_eig_reference, hess_eig_solve
from tensorkrylov_tpu_torch.ops.orth import arnoldi_algorithm

torch.set_num_threads(1)

F64 = torch.float64


def _random_hessenberg(d, K, k, seed, tiny_at=None):
    g = np.random.default_rng(seed)
    H = np.zeros((d, K, K))
    H[:, :k, :k] = np.triu(g.standard_normal((d, k, k)), -1)
    if tiny_at is not None:
        H[:, tiny_at, tiny_at - 1] = 1e-17
    H[:, k:, :] = g.standard_normal((d, K - k, K))      # padding the active block must not read
    H[:, :k, k:] = g.standard_normal((d, k, K - k))
    return torch.tensor(H)


@functools.lru_cache(maxsize=1)
def _convdiff_hessenberg(k=24):
    """Arnoldi's H of conv_diff(2, 40) after k steps, scaled to O(1)."""
    op = tkt.conv_diff(2, 40, shift=5.0, device="cpu")
    st = arnoldi_algorithm(op, tkt.random_rhs(2, 40, seed=3, identical=False), k)
    H = st.H / st.H.abs().max()
    return H, st.btil


CASES = {
    "random_k8": (_random_hessenberg, dict(d=3, K=8, k=8, seed=1)),
    "k1": (_random_hessenberg, dict(d=2, K=4, k=1, seed=2)),
    "k2": (_random_hessenberg, dict(d=3, K=2, k=2, seed=3)),
    "k3_padded": (_random_hessenberg, dict(d=2, K=9, k=3, seed=4)),
    "padded_k20_K31": (_random_hessenberg, dict(d=2, K=31, k=20, seed=5)),
    "tiny_subdiagonal": (_random_hessenberg, dict(d=2, K=16, k=16, seed=6, tiny_at=7)),
    "convdiff_arnoldi": (lambda: _convdiff_hessenberg()[0], {}),
}


def _eig_close(H, k, got):
    """Eigenvalues as multisets against torch.linalg.eig, and the residual
    ‖HS − SΛ‖/‖H‖ of the twin's own pairs."""
    w, V, info = got
    assert info.dtype == torch.int32 and torch.equal(info, torch.zeros_like(info))
    for f in range(H.shape[0]):
        A = torch.triu(H[f, :k, :k], -1)
        ref = torch.linalg.eigvals(A).numpy()
        mine = w[f].numpy()
        # match each reference eigenvalue to its nearest, each used once
        used = np.zeros(k, bool)
        for z in ref:
            dist = np.where(used, np.inf, np.abs(mine - z))
            j = int(np.argmin(dist))
            used[j] = True
            assert dist[j] <= 1e-10 * max(1.0, float(torch.linalg.matrix_norm(A))), (f, z, mine[j])
        res = torch.linalg.matrix_norm(A.to(V.dtype) @ V[f] - V[f] * w[f][None, :]) / torch.linalg.matrix_norm(A)
        assert float(res) <= 1e-12, (f, float(res))
        np.testing.assert_allclose(torch.linalg.vector_norm(V[f], dim=0).numpy(), 1.0, rtol=0, atol=1e-14)
        # a conjugate pair's vectors are conjugate columns
        for c in range(k - 1):
            if w[f, c].imag > 0:
                assert w[f, c + 1] == w[f, c].conj()
                assert torch.equal(V[f, :, c + 1], V[f, :, c].conj())


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_eig(case):
    make, kw = CASES[case]
    H = make(**kw)
    k = kw.get("k", H.shape[1])
    got = hess_eig(H, k)
    assert got.w.shape == (H.shape[0], k) and got.V.shape == (H.shape[0], k, k)
    _eig_close(H, k, got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_through_triangular_x_matches_lu(case):
    """g = V⁻¹ b through the triangular X (column operations of modulus one
    per conjugate pair) against an LU solve with V: 1e-11 relative to g."""
    make, kw = CASES[case]
    H = make(**kw)
    k = kw.get("k", H.shape[1])
    b = torch.tensor(np.random.default_rng(1).standard_normal((H.shape[0], k, 2)))
    (w, V, info), g = hess_eig_solve(H, k, b)
    assert torch.equal(w, hess_eig(H, k).w) and torch.equal(V, hess_eig(H, k).V)
    ref = torch.linalg.solve(V, b.to(V.dtype))
    assert float((g - ref).abs().max()) <= 1e-11 * float(ref.abs().max())


def test_twin_finds_complex_pairs():
    """A rotation-like block gives a conjugate pair; random Hessenbergs of
    order 8 have pairs in most factors."""
    H = _random_hessenberg(3, 8, 8, seed=1)
    w = hess_eig(H, 8).w
    assert int((w.imag.abs() > 1e-8).sum()) >= 2


def test_twin_reference_is_the_cpu_path():
    H = _random_hessenberg(2, 10, 7, seed=7)
    a, b = hess_eig(H, 7), hess_eig_reference(H, 7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_twin_reports_no_convergence():
    """NaN never deflates: the iteration cap stops it and info names the row."""
    H = _random_hessenberg(2, 5, 5, seed=8)
    H[1, 2, 1] = float("nan")
    info = hess_eig(H, 5).info
    assert int(info[0]) == 0 and int(info[1]) > 0


@pytest.mark.parametrize("bad,err", [
    (lambda H: (H.float(), 4), TypeError),
    (lambda H: (H[0], 4), ValueError),
    (lambda H: (H[:, :, :5], 4), ValueError),
    (lambda H: (H, 0), ValueError),
    (lambda H: (H, 7), ValueError),
], ids=["dtype", "2d", "not_square", "k0", "k_above_K"])
def test_wrapper_rejects(bad, err):
    H = _random_hessenberg(2, 6, 6, seed=9)
    with pytest.raises(err):
        hess_eig(*bad(H))


def _coeffs(H, k):
    lmin = 0.05
    st = select_stenger(torch.tensor(1e-9 * lmin), 101, F64, torch.device("cpu"))
    return st.omega, st.alpha, st.t_mask, torch.tensor(lmin, dtype=F64)


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("k", [6, 24])
def test_factors_through_twin_match_eig(k, R):
    """The check's factors, y = S exp(−γΛ) S⁻¹ b̃, through the twin on the
    active block against torch.linalg.eig on the padded stack: 1e-10
    relative to the largest entry; rows past k zero on both sides."""
    H, bt = _convdiff_hessenberg()
    K = H.shape[1]
    H = H.clone()
    H[:, k + 1:, :] = 0.0
    H[:, :, k:] = 0.0
    bt = bt.clone()
    bt[:, k:] = 0.0
    if R > 1:
        bt = torch.stack([bt * (r + 1.0) + 0.1 * r for r in range(R)], dim=2)
        bt[:, k:] = 0.0
    args = (H, bt, k, *_coeffs(H, k))
    w_ref, Y_ref = expsum.cp_solve_nonsym_eig(*args)
    w_tw, Y_tw, info = expsum._cp_solve_hessenberg(*args)
    assert int(info) == 0
    assert torch.equal(w_ref, w_tw)
    assert Y_tw.shape == Y_ref.shape == (2, K, 101 * R)
    assert torch.count_nonzero(Y_tw[:, k:]) == 0
    scale = float(Y_ref.abs().max())
    np.testing.assert_allclose(Y_tw.numpy(), Y_ref.numpy(), rtol=0, atol=1e-10 * scale)


def test_cpu_tensor_reaches_eig(monkeypatch):
    """A CPU tensor takes torch.linalg.eig even when its H is Hessenberg,
    and returns no info: the library raises itself."""
    calls = []
    real = torch.linalg.eig
    monkeypatch.setattr(torch.linalg, "eig", lambda A: calls.append(A.shape) or real(A))
    H, bt = _convdiff_hessenberg()
    out = expsum.cp_solve_nonsym_eig_ex(H, bt, 10, *_coeffs(H, 10), hessenberg=True)
    assert out[2] is None and calls == [H.shape]


@pytest.mark.parametrize("R", [1, 2])
def test_callers_pass_the_structure_they_built(monkeypatch, R):
    """projected_step reads H's structure from the subdiagonal its caller
    hands it: solve's (d,) entries give hessenberg=True, solve_block's
    (d, R, R) blocks R == 1 (block Arnoldi's H has R subdiagonals); on the
    CPU both still reach torch.linalg.eig."""
    seen, eigs = [], []
    real_ex, real_eig = expsum.cp_solve_nonsym_eig_ex, torch.linalg.eig

    def spy(*a, hessenberg=False):
        seen.append(hessenberg)
        return real_ex(*a, hessenberg=hessenberg)

    monkeypatch.setattr(solver, "cp_solve_nonsym_eig_ex", spy)
    monkeypatch.setattr(torch.linalg, "eig", lambda A: eigs.append(1) or real_eig(A))
    op = tkt.conv_diff(2, 20, shift=5.0, device="cpu")
    cfg = tkt.SolverConfig(kmax=8, tol=1e-6, orth="arnoldi", tmax=101, check_every=4)
    B = torch.stack([tkt.random_rhs(2, 20, seed=r, identical=False) for r in range(R)])
    block.solve_block(op, B, cfg)
    assert seen and all(h == (R == 1) for h in seen) and len(eigs) == len(seen)
    seen.clear()
    tkt.solve(op, B[0], cfg)
    assert seen and all(seen)


def test_status_read_raises_on_eig_fault():
    """The check's one status read carries the eig's info and raises."""
    K = 5
    h = solver._new_history(K, F64, torch.device("cpu"))
    one = torch.tensor(1.0, dtype=F64)
    ev = solver.ProjectedEval(one, one, one * 0.5, one, one, one, torch.tensor(3, dtype=torch.int32),
                              torch.tensor(False), torch.tensor(1, dtype=torch.int32))
    cfg = tkt.SolverConfig(kmax=K - 1, tol=1e-8, orth="arnoldi")
    with pytest.raises(torch.linalg.LinAlgError, match="did not converge"):
        solver._record_check(h, 2, ev, cfg)
    ok = ev._replace(info=torch.tensor(0, dtype=torch.int32))
    assert solver._record_check(h, 2, ok, cfg) == tkt.Status.RUNNING


@pytest.mark.parametrize("symmetric,device,impl,kmax,refused", [
    (False, "cuda", "eig", 1025, True),
    (False, "cuda", "eig", 1024, False),
    (False, "cpu", "eig", 1025, False),
    (True, "cuda", "eig", 1025, False),
    (False, "cuda", "expm", 1025, False),
], ids=["card_above_cap", "card_at_cap", "cpu", "symmetric", "expm"])
def test_setup_refuses_a_kmax_past_the_kernel(symmetric, device, impl, kmax, refused):
    """A nonsymmetric eig check on the card runs hess_eig on the active block
    (at most kmax): a kmax past its MAX_K is refused when the solve is set
    up; the CPU, the symmetric path and 'expm' take any kmax."""
    from types import SimpleNamespace
    from tensorkrylov_tpu_torch.ops.hess_eig import MAX_K
    assert MAX_K == 1024
    op = SimpleNamespace(symmetric=symmetric, device=torch.device(device))
    cfg = tkt.SolverConfig(kmax=kmax, orth="arnoldi", nonsym_solve_impl=impl)
    if refused:
        with pytest.raises(ValueError, match="kmax <= 1024"):
            solver._check_hess_eig_size(op, cfg)
    else:
        solver._check_hess_eig_size(op, cfg)
