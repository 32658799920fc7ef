"""Config 4's block-step count: the JAX package's plain solve_block and the
port's, on the CPU, at config 4's recipe (d=10, n=10240, R=4, κ=1e4 per
factor, kmax 96, check_every 8), which tests/test_torch_cuda.py's
test_config4_block_and_recorded_on_card runs on the card (and the sharded
block tests at n=2048). Both stop at the same block step with the same
estimates.

The TPU artifact (tensorkrylov_tpu/experiments/data/config4_block_d10_n10240_r4.json)
records 64 block steps: it is solve_block_recorded with checkpoints 8, 16,
32, 64, whose certified bound at 32 (1.0168e-8) was just above tol 1e-8.

Full width, so marked slow (~25 s and ~1 GB): run it with
`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_config4_steps.py -m slow -s`;
it prints both packages' estimates at each check."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu as tk
import tensorkrylov_tpu_torch as tkt

D, N, R, KAPPA, SEED = 10, 10240, 4, 1e4, 1234
CONFIG = dict(kmax=96, tol=1e-8, check_every=8, orth="lanczos_reorth", spectral_source="H")
TRACE_RTOL = 1e-10  # f64 traces of the two packages' block solves (CGS2; ~1e-13 at d=3, tests/test_torch_block.py)


def sigma_for_kappa(n, kappa):
    """Diagonal shift that gives a Laplacian factor the condition number κ (tests/test_torch_cuda.py's)."""
    lmax = 4.0 * (n + 1) ** 2 * np.sin(n * np.pi / (2 * (n + 1))) ** 2
    lmin = 4.0 * (n + 1) ** 2 * np.sin(np.pi / (2 * (n + 1))) ** 2
    return float((lmax - kappa * lmin) / (kappa - 1.0))


@pytest.mark.slow
def test_config4_block_steps_match_jax():
    sigma = sigma_for_kappa(N, KAPPA)
    B = np.random.default_rng(SEED).standard_normal((R, D, N))
    B /= np.linalg.norm(B, axis=2, keepdims=True)
    ref = tk.solve_block(tk.reaction_diffusion(D, N, sigma=sigma), jnp.asarray(B), tk.SolverConfig(**CONFIG))
    res = tkt.solve_block(tkt.reaction_diffusion(D, N, sigma, device="cpu"), torch.tensor(B),
                          tkt.SolverConfig(**CONFIG))
    k = int(ref.niterations)
    assert (int(res.status), int(res.niterations)) == (int(ref.status), k) == (int(tk.Status.CONVERGED), 32)
    checks = list(range(8, k + 1, 8))
    jr = np.asarray(ref.relative_residual, np.float64)[checks]
    pr = res.relative_residual.numpy()[checks]
    print({"checks": checks, "jax": jr.tolist(), "port": pr.tolist()})
    np.testing.assert_allclose(pr, jr, rtol=TRACE_RTOL)
    assert jr[-1] <= CONFIG["tol"] < jr[-2]
