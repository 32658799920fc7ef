"""Restarted solve by CP iterative refinement, bounded Krylov memory with an
exact low-rank residual: counterpart of ``tensorkrylov_tpu/refine.py``.

After a bounded-kmax cycle the true residual r = b − A x is formed in CP form
(``kron_apply_cp``; n^d is never materialized), rounded to a small CP rank
(``cp_round``, ALS), and the correction equation A e = r is solved in a fresh
shared block-Krylov space (``block.solve_block``) with r's rank-R rounded form
as the right-hand side. The solution accumulates as a CP sum.

Attainable accuracy (f64): ‖r‖ comes from t×t Gram products, whose
cancellation floor is about 1e-8·‖b‖ relative; cp_round's fit error is about
√eps relative to the term magnitudes of r, which cancel down to ‖r‖, so the
per-cycle reduction shrinks as ‖r‖ falls. The controlling quantity is the
representation condition κ_rep = Σ_j |w_j|·Π‖r_s[:,j]‖ / ‖r‖, recorded per
cycle in rep_condition; refinement stalls (and keeps the best iterate) once
κ_rep approaches 1/tol_cycle.

This is host control flow over ``solve``, ``solve_block`` and ``utils/cp``; the
tensors stay on the operator's device. Given a ``ShardedOperator``, every
inner solve runs over its mesh and the CP residual's SpMV over its pieces;
the CP algebra (x, r, their rounding) stays whole on the lead device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .block import solve_block
from .coeffs.tables import load_tables
from .solver import solve
from .parallel.krylov import whole
from .types import CPTensor, SolverConfig, Status
from .utils.cp import cp_axpy, cp_compress, cp_norm, cp_round, kron_apply_cp

__all__ = ["solve_refined", "RefinedResult", "cp_residual"]


def cp_residual(op, x: CPTensor, b) -> CPTensor:
    """b − A x as a CP tensor (rank 1 + d·rank(x)); b is rank-1 (d, n)."""
    b = torch.as_tensor(b, device=x.factors.device)
    b_cp = CPTensor(torch.ones((1,), dtype=x.weights.dtype, device=b.device), b[:, :, None])
    return cp_axpy(-1.0, kron_apply_cp(op, x), b_cp)


@dataclasses.dataclass(frozen=True)
class RefinedResult:
    x: CPTensor
    status: int                      # Status value of the final state
    cycles: int
    true_relative_residual: float    # exact CP-evaluated ‖b−Ax‖/‖b‖
    residual_history: List[float]    # per-cycle true relative residuals
    inner_iterations: List[int]      # Krylov iterations of each cycle
    rep_condition: List[float]       # per-cycle κ_rep of the CP residual

    @property
    def converged(self):
        return self.status == Status.CONVERGED


def solve_refined(
    op,
    b,
    config: Optional[SolverConfig] = None,
    *,
    max_restarts: int = 4,
    residual_rank: int = 6,
    solution_rank: Optional[int] = None,
    round_iters: int = 20,
    inner_tol: float = 1e-4,
) -> RefinedResult:
    """Solve A x = b (rank-1 b, (d, n)) by restarted refinement cycles.

    Each cycle's Krylov space is bounded by config.kmax; config.tol is the
    final target, checked against the exact CP residual. inner_tol is the
    per-cycle relative reduction asked of the inner solver.

    residual_rank: CP rank the residual is rounded to before the correction
    solve (the attainable per-cycle reduction is limited by this rounding).
    solution_rank: if set, the accumulated solution is rounded to this rank
    each cycle (default: kept exact, the rank grows by tmax·residual_rank).
    """
    config = config or SolverConfig()
    b = torch.as_tensor(whole(op, b) if isinstance(b, list) else b, device=op.device)
    if b.dim() != 2 or b.shape[0] != op.d or b.shape[1] != op.n:
        raise ValueError(f"b must be (d, n) = ({op.d}, {op.n}), got {tuple(b.shape)}")
    tables = load_tables(dtype=config.proj_dtype, device=op.device) if op.symmetric else None
    inner_cfg = dataclasses.replace(config, tol=inner_tol)

    b_norm = float(np.prod(np.linalg.norm(b.detach().cpu().numpy().astype(np.float64), axis=1)))

    history: List[float] = []
    inner_iters: List[int] = []

    # cycle 1: the rank-1 RHS through solve
    res = solve(op, b, inner_cfg, tables)
    x = cp_compress(res.x, rel_tol=0.0)
    inner_iters.append(int(res.niterations))

    # The inner solves' own statuses (BREAKDOWN of their residual estimator
    # included) are advisory: termination is decided by the exact CP residual.
    status = int(Status.MAXITER)
    rel_prev = float("inf")
    x_prev = x  # the best iterate so far
    rep_cond: List[float] = []
    cur_rank = residual_rank
    corrections = 0
    stalls = 0
    while True:
        r = cp_residual(op, x, b)
        rel = float(cp_norm(r)) / b_norm
        term_mass = float(torch.sum(torch.abs(r.weights)
                                    * torch.prod(torch.linalg.vector_norm(r.factors, dim=1), dim=0)))
        if rel < config.tol:
            history.append(rel)
            rep_cond.append(term_mass / max(rel * b_norm, 1e-300))
            status = int(Status.CONVERGED)
            break
        if rel >= rel_prev:
            # stalled (the rank-`cur_rank` rounding of an ill-conditioned CP
            # residual lost the signal): revert to the better iterate and
            # retry with a richer rounded residual before giving up
            x = x_prev
            stalls += 1
            cur_rank = min(2 * cur_rank, 4 * residual_rank)
            if stalls > 2 or corrections > max_restarts + 2:
                break
            r = cp_residual(op, x, b)
        else:
            history.append(rel)
            rep_cond.append(term_mass / max(rel * b_norm, 1e-300))
            stalls = 0
            rel_prev, x_prev = rel, x
            if corrections >= max_restarts:
                break
        # round the residual and solve the correction equation
        rr = cp_round(r, min(cur_rank, r.rank), iters=round_iters)
        B = rr.factors.permute(2, 0, 1).clone(memory_format=torch.contiguous_format)  # (R, d, n), a copy
        B[:, 0, :] *= rr.weights[:, None]                      # fold the weights into mode 0
        cres = solve_block(op, B, inner_cfg, tables)
        inner_iters.append(int(cres.niterations))
        corrections += 1
        x = cp_axpy(1.0, cp_compress(cres.x, rel_tol=0.0), x)
        if solution_rank is not None and x.rank > solution_rank:
            x = cp_round(x, solution_rank, iters=round_iters)

    return RefinedResult(
        x=x,
        status=status,
        cycles=len(inner_iters),
        true_relative_residual=history[-1] if history else float("inf"),
        residual_history=history,
        inner_iterations=inner_iters,
        rep_condition=rep_cond,
    )
