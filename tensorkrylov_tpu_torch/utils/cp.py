"""CP-tensor utilities and dense oracles: the subset of
``tensorkrylov_tpu/utils/cp.py`` that the tests and the chip smoke use."""
from __future__ import annotations

import numpy as np
import torch

from ..models.gallery import bands_to_dense
from ..types import CPTensor, KroneckerSumOperator

__all__ = ["cp_dot", "cp_norm", "cp_full", "kron_matvec_dense", "kron_residual_dense"]


def cp_dot(x: CPTensor, y: CPTensor) -> torch.Tensor:
    """⟨x, y⟩ = Σ_{ij} λ_i μ_j Π_s ⟨x_s[:,i], y_s[:,j]⟩ — O(d·t²·n)."""
    G = torch.einsum("dni,dnj->dij", x.factors, y.factors)
    return x.weights @ torch.prod(G, dim=0) @ y.weights


def cp_norm(x: CPTensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(cp_dot(x, x), min=0.0))


def cp_full(x: CPTensor) -> np.ndarray:
    """Materialize to a length-n^d numpy vector (tests only; tiny problems)."""
    factors = x.factors.detach().cpu().numpy()
    weights = x.weights.detach().cpu().numpy()
    d, n, t = factors.shape
    out = np.zeros(n**d)
    for j in range(t):
        acc = np.array([1.0])
        for s in range(d):
            acc = np.kron(acc, factors[s, :, j])
        out += weights[j] * acc
    return out


def kron_matvec_dense(op: KroneckerSumOperator, v: np.ndarray) -> np.ndarray:
    """Dense oracle: apply the full Kronecker-sum operator to a flat vector."""
    A = bands_to_dense(op)
    d, n, _ = A.shape
    out = np.zeros_like(v)
    x = v.reshape((n,) * d)
    for s in range(d):
        out += np.moveaxis(np.tensordot(A[s], x, axes=([1], [s])), 0, s).reshape(-1)
    return out


def kron_residual_dense(op: KroneckerSumOperator, x: CPTensor, b) -> float:
    """True relative residual ‖Ax − b‖/‖b‖ via full materialization (oracle)."""
    b = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    bfull = np.array([1.0])
    for s in range(b.shape[0]):
        bfull = np.kron(bfull, b[s])
    r = kron_matvec_dense(op, cp_full(x)) - bfull
    return float(np.linalg.norm(r) / np.linalg.norm(bfull))
