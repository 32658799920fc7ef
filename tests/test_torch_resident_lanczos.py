"""The port's resident multi-step Lanczos (its plain version, which CPU
tensors take) against the JAX package's Pallas kernel in interpret mode, and
against a plain f32 step summed in the same order; the freeze at β' ≤ 1e-30;
the eligibility rules of step_impl='resident'; the kernel's cluster plan."""
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

import tensorkrylov_tpu as tk
import tensorkrylov_tpu.ops.pallas.resident_lanczos as rl
import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch.interop import operator_from_numpy
from tensorkrylov_tpu_torch.ops import _build, resident_lanczos
from tensorkrylov_tpu_torch.ops.fused_lanczos import fused_lanczos_core_reference
from tensorkrylov_tpu_torch.ops.orth import _sqrt_rn
from tensorkrylov_tpu_torch.ops.resident_lanczos import (
    lanczos_resident_steps,
    lanczos_resident_steps_reference,
    lanczos_resident_supported,
    resident_lanczos_plan,
)
from tensorkrylov_tpu_torch.solver import _resident_eligible, _resolve_config

torch.set_num_threads(1)

F32 = torch.float32


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(rl.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    # bypass the jit cache, which would hold the compiled non-interpret version
    monkeypatch.setattr(rl, "_resident_steps_chunk", rl._resident_steps_chunk.__wrapped__)


def _start(d, n, seed):
    """Unit-norm start rows, zero vpp and β, as numpy f32."""
    b = np.random.default_rng(seed).standard_normal((d, n)).astype(np.float32)
    return b / np.linalg.norm(b, axis=1, keepdims=True), np.zeros((d, n), np.float32), np.zeros(d, np.float32)


@pytest.mark.parametrize("S", [1, 3, 7])
def test_reference_matches_pallas_kernel(interpret_mode, S):
    """The JAX test's problem and tolerances: the two sum in other orders, so
    the f32 recurrences agree to f32-accumulation accuracy over a few steps."""
    jop = tk.laplace(2, 512, shift=5.0, dtype=jnp.float32)
    vp, vpp, beta = _start(2, 512, 0)
    ref = rl._resident_steps(jop.bands, *map(jnp.asarray, (vp, vpp, beta)), jop.offsets, S)
    op = operator_from_numpy(np.asarray(jop.bands), jop.offsets)
    got = lanczos_resident_steps(op, *map(torch.tensor, (vp, vpp, beta)), S)
    V, al, bt, vpn, vppn, bn = (np.asarray(r) for r in ref)
    np.testing.assert_allclose(got.alpha.numpy(), al, rtol=2e-4, atol=1e-3 * np.abs(al).max())
    np.testing.assert_allclose(got.beta.numpy(), bt, rtol=2e-4)
    np.testing.assert_allclose(got.V.numpy(), V, atol=5e-4)
    np.testing.assert_allclose(got.vp.numpy(), vpn, atol=5e-4)
    np.testing.assert_allclose(got.vpp.numpy(), vppn, atol=5e-4)
    np.testing.assert_allclose(got.beta_last.numpy(), bn, rtol=2e-4)


@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-5, -2, 0, 3, 5)], ids=["tri", "wide"])
def test_reference_equals_plain_steps_bitwise(offsets):
    """S steps of the plain version equal S plain f32 steps built from the
    fused core's plain version (the same fixed-order sums), a correctly
    rounded square root and a multiply by the reciprocal: equal bits."""
    d, n, S = 3, 1001, 9
    rng = np.random.default_rng(4)
    bands = rng.uniform(-1.0, 1.0, (d, len(offsets), n)).astype(np.float32)
    for b, off in enumerate(offsets):
        bands[:, b, max(0, n - off):] = 0.0
        bands[:, b, :max(0, -off)] = 0.0
    op = operator_from_numpy(bands, offsets)
    vp, vpp, beta = (torch.tensor(x) for x in _start(d, n, 5))
    got = lanczos_resident_steps_reference(op, vp, vpp, beta, S)
    for j in range(S):
        u, alpha, beta_sq, _ = fused_lanczos_core_reference(op, vp, vpp, beta, vp)
        beta_new = _sqrt_rn(beta_sq)
        v = u * (1.0 / beta_new)[:, None]
        assert torch.equal(got.V[j], v) and torch.equal(got.alpha[:, j], alpha) and torch.equal(got.beta[:, j], beta_new)
        vp, vpp, beta = v, vp, beta_new
    assert torch.equal(got.vp, vp) and torch.equal(got.vpp, vpp) and torch.equal(got.beta_last, beta)


def test_freeze_below_threshold():
    """A start vector that spans an invariant subspace (an eigenvector of a
    diagonal factor) gives u = 0 exactly: a zero column, β' = 0, and every
    later step stays zero; the other factor runs on."""
    d, n = 2, 16
    op = tkt.eigval_matrix(np.stack([np.arange(1.0, n + 1), np.linspace(1.0, 3.0, n)]), dtype=F32, device="cpu")
    vp = torch.zeros((d, n), dtype=F32)
    vp[0, 3] = 1.0
    vp[1] = 1.0 / np.sqrt(n)
    got = lanczos_resident_steps(op, vp, torch.zeros_like(vp), torch.zeros(d, dtype=F32), 4)
    assert float(got.alpha[0, 0]) == 4.0
    assert torch.count_nonzero(got.V[:, 0]) == 0 and torch.count_nonzero(got.beta[0]) == 0
    assert torch.count_nonzero(got.alpha[0, 1:]) == 0 and float(got.beta_last[0]) == 0.0
    assert bool(torch.all(got.beta[1] > 0.1)) and bool(torch.all(torch.isfinite(got.V[:, 1])))


def test_out_argument_writes_in_place():
    op = tkt.laplace(2, 64, shift=3.0, dtype=F32, device="cpu")
    vp, vpp, beta = (torch.tensor(x) for x in _start(2, 64, 6))
    V = torch.zeros((6, 2, 64), dtype=F32)
    got = lanczos_resident_steps(op, vp, vpp, beta, 4, out=V[1:5])
    assert got.V.data_ptr() == V[1].data_ptr()
    assert torch.equal(V[1:5], lanczos_resident_steps(op, vp, vpp, beta, 4).V)
    assert torch.count_nonzero(V[0]) == 0 and torch.count_nonzero(V[5]) == 0


def test_other_devices_raise_and_cpu_counts_no_launch():
    op = tkt.laplace(2, 8, dtype=F32, device="cpu")
    meta = torch.empty((2, 8), dtype=F32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lanczos_resident_steps(op, meta, meta, torch.empty(2, dtype=F32, device="meta"), 2)
    before = dict(_build.launches)
    lanczos_resident_steps(op, torch.ones((2, 8), dtype=F32), torch.zeros((2, 8), dtype=F32),
                           torch.zeros(2, dtype=F32), 2)
    assert dict(_build.launches) == before


@pytest.mark.parametrize("fields,op_kind,eligible", [
    (dict(orth="lanczos", basis_dtype=F32), "laplace", True),
    (dict(orth="lanczos", basis_dtype=F32), "laplace_n100", True),  # the JAX package needs n % 128 == 0
    (dict(orth="lanczos", basis_dtype=torch.float64), "laplace", False),
    (dict(orth="lanczos_reorth", basis_dtype=F32), "laplace", False),
    (dict(orth="lanczos_reorth_auto", basis_dtype=F32), "laplace", False),
    (dict(orth="arnoldi", basis_dtype=F32), "conv_diff", False),
])
def test_eligibility_rules(fields, op_kind, eligible):
    op = {"laplace": tkt.laplace(2, 128, device="cpu"), "laplace_n100": tkt.laplace(2, 100, device="cpu"),
          "conv_diff": tkt.conv_diff(2, 128, device="cpu")}[op_kind]
    cfg = tkt.SolverConfig(step_impl="resident", **fields)
    assert _resident_eligible(cfg, op) == eligible
    assert _resolve_config(cfg, op, host_projected=True).step_impl == ("resident" if eligible else "xla")
    assert _resolve_config(cfg, op).step_impl == "xla"  # solve() has no segments
    assert lanczos_resident_supported(op.astype(F32)) and not lanczos_resident_supported(op)


# The card's answers to the plan's two questions, for an H100-like card (132 SMs)
# and for one that runs no cluster larger than one block.
H100_FIT = {1: 132, 2: 66, 4: 32, 8: 16, 16: 7}
NO_CLUSTERS = {1: 132, 2: 0, 4: 0, 8: 0, 16: 0}


@pytest.mark.parametrize("fit,d,n,want", [
    (H100_FIT, 10, 131072, 8),      # 10 clusters of 8 fit at once; of 16, two rounds
    (H100_FIT, 8, 1 << 20, 8),      # 8 clusters of 16 would take two rounds when 7 fit
    ({**H100_FIT, 16: 8}, 8, 1 << 20, 16),
    (H100_FIT, 1, 300, 2),          # two chunks: no more blocks than chunks
    (H100_FIT, 3, 100, 1),          # one chunk
    (H100_FIT, 200, 131072, 1),     # d fills every SM
    (NO_CLUSTERS, 10, 131072, 1),
    ({1: 132, 2: 66, 4: 32, 8: 0, 16: 0}, 10, 131072, 4),
])
def test_resident_plan(monkeypatch, fit, d, n, want):
    """G from the SM count and the cluster occupancy alone: 1 <= G <= 16, at
    least one cluster of G fits, and G = 1 where no larger cluster does."""
    monkeypatch.setattr(resident_lanczos, "_sm_count", lambda device: 132)
    monkeypatch.setattr(resident_lanczos, "_max_active_clusters", lambda G, device, smem: fit[G])
    G = resident_lanczos_plan(d, n, "cuda:0")
    assert G == want and 1 <= G <= 16 and fit[G] >= 1
