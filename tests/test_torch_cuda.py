"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and a solve that must go through them. These tests skip where no
CUDA device is present. This file imports no JAX, so on a machine with the
card and without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.ops import _build
from tensorkrylov_tpu_torch.ops.banded import spmv, spmv_reference
from tensorkrylov_tpu_torch.ops.fused_lanczos import fused_lanczos_core, fused_lanczos_core_reference

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _op(offsets, d, n, seed, dtype, device):
    bands = np.random.default_rng(seed).uniform(-1.0, 1.0, (d, len(offsets), n))
    for b, off in enumerate(offsets):
        if off > 0:
            bands[:, b, n - off:] = 0.0
        elif off < 0:
            bands[:, b, :-off] = 0.0
    return tkt.KroneckerSumOperator(torch.tensor(bands, dtype=dtype, device=device), offsets)


@pytest.mark.parametrize("shape", [(3, 1001), (3, 4, 1001), (10, 131072)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_kernel_equals_plain(cuda, dtype, shape):
    """Same products, summed in the same order, each rounded: equal bits."""
    op = _op((-2, -1, 0, 1, 2), shape[0], shape[-1], 0, dtype, cuda)
    v = torch.randn(shape, dtype=dtype, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    before = _build.launches["banded_spmv"]
    got = spmv(op, v)
    torch.cuda.synchronize()
    assert _build.launches["banded_spmv"] == before + 1
    assert torch.equal(got, spmv_reference(op, v))


@pytest.mark.parametrize("n", [50001, 131072])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_kernel_matches_plain(cuda, dtype, n):
    """Each operation rounded on its own and the sums taken in the kernel's
    fixed order on both sides: equal bits, from the CPU too."""
    d = 4
    op = _op((-1, 0, 1), d, n, 2, dtype, cuda)
    g = torch.Generator(cuda).manual_seed(3)
    v_prev, v_pprev, b = (torch.randn((d, n), dtype=dtype, device=cuda, generator=g) for _ in range(3))
    beta = torch.rand(d, dtype=dtype, device=cuda, generator=g)
    got = fused_lanczos_core(op, v_prev, v_pprev, beta, b)
    ref = fused_lanczos_core_reference(op, v_prev, v_pprev, beta, b)
    assert all(torch.equal(a, x) for a, x in zip(got, ref))
    cpu_op = tkt.KroneckerSumOperator(op.bands.cpu(), op.offsets)
    on_cpu = fused_lanczos_core(cpu_op, *(t.cpu() for t in (v_prev, v_pprev, beta, b)))
    assert all(torch.equal(a.cpu(), x) for a, x in zip(got, on_cpu))
    # fixed reduction trees, no atomics: a second launch repeats bit for bit
    again = fused_lanczos_core(op, v_prev, v_pprev, beta, b)
    assert all(torch.equal(a, x) for a, x in zip(got, again))


@pytest.mark.parametrize("basis_dtype", [torch.float32, torch.float64])
def test_fused_recurrence_equals_cpu(cuda, basis_dtype):
    """Without reorthogonalization rounding grows from step to step, so the
    fused recurrence must give the same bits on the card as on the CPU."""
    from tensorkrylov_tpu_torch.ops.orth import init_state, lanczos_step

    op = tkt.reaction_diffusion(3, 5000, 1e6)
    b = tkt.random_rhs(3, 5000, seed=5, identical=False)
    out = {}
    for dev in ("cpu", cuda):
        dop = tkt.KroneckerSumOperator(op.bands.to(dev).to(basis_dtype), op.offsets)
        st, _ = init_state(dop, b.to(dev), 30, torch.float64, basis_dtype)
        for k in range(1, 31):
            st, _ = lanczos_step(dop, st, b.to(dev), k, reorth=False, proj_dtype=torch.float64, fused=True)
        out[str(dev)] = [t.cpu() for t in st]
    assert all(torch.equal(a, c) for a, c in zip(out["cpu"], out[str(cuda)]))


def test_kernel_wrappers_reject_bad_input(cuda):
    op = _op((-1, 0, 1), 2, 64, 4, torch.float64, cuda)
    with pytest.raises(TypeError):
        spmv(op, torch.ones((2, 64), dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        spmv(op, torch.ones((2, 128), dtype=torch.float64, device=cuda)[:, ::2])
    v = torch.ones((2, 64), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        fused_lanczos_core(op, v, v, torch.ones(3, dtype=torch.float64, device=cuda), v)


@pytest.mark.parametrize("fields,kernel", [
    (dict(), "banded_spmv"),
    (dict(orth="lanczos_reorth_auto", step_impl="fused"), "fused_lanczos"),
])
def test_solve_on_card_goes_through_kernel(cuda, fields, kernel):
    op = tkt.laplace(3, 30, device=cuda)
    b = tkt.random_rhs(3, 30, seed=7, device=cuda)
    _build.launches.clear()
    res = tkt.solve(op, b, tkt.SolverConfig(kmax=30, tol=1e-8, **fields))
    assert res.status == tkt.Status.CONVERGED
    assert _build.launches[kernel] == res.niterations
    assert tkt.kron_residual_dense(op, res.x, b) <= 1e-8
