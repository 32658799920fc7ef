"""The one traffic generator: what a traffic file's parameters ask for, made
from the seed.

A traffic file (``tkbench/traffic/<name>.json``) holds data only:

  rhs            pool size and distribution of the right-hand sides;
  solver         SolverConfig fields this mix sets over the configuration's;
  call           keyword arguments of the entry point this mix sets;
  warmup_solves  solves of the cell's own shape run in set-up;
  check_sample   how many of the window's solves the reference checks.

The loop is closed with one caller: each solve starts when the previous
one has returned and synchronized.
"""
from __future__ import annotations

import random

import torch

__all__ = ["rhs_pool", "Schedule"]


def rhs_pool(rhs: dict, d: int, n: int, seed: int, device) -> torch.Tensor:
    """(pool, d, n) f64 right-hand sides on device, from one generator on that
    device: entries uniform on [0, 1) ('uniform01'), each of the d rows
    scaled to unit norm when rows == 'unit'."""
    if rhs["distribution"] != "uniform01":
        raise ValueError(f"unknown rhs distribution {rhs['distribution']!r}")
    g = torch.Generator(device=device).manual_seed(int(seed))
    B = torch.rand((int(rhs["pool"]), d, n), generator=g, dtype=torch.float64, device=device)
    if rhs.get("rows") == "unit":
        B /= torch.linalg.vector_norm(B, dim=2, keepdim=True)
    return B


class Schedule:
    """Which pool entry each solve takes, and which of the window's solves
    the reference checks, both drawn from the seed. The pool is taken in a
    seeded order and cycled; the set-up's warm solves take its first
    entries, the window goes on from there."""

    def __init__(self, pool: int, seed: int):
        self._rng = random.Random(int(seed) ^ 0x7B3C)
        self._order = list(range(pool))
        self._rng.shuffle(self._order)
        self._next = 0

    def next_rhs(self) -> int:
        i = self._order[self._next % len(self._order)]
        self._next += 1
        return i

    def checked(self, expected: int, k: int) -> set:
        """k positions of the window drawn among the first four fifths of the
        solves it is expected to complete, so that each is due."""
        span = max(1, (4 * expected) // 5)
        return set(self._rng.sample(range(span), min(k, span)))
