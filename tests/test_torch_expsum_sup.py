"""The exp-sum sup error in double-double (ops/expsum.py:expsum_sup_error_dd,
the plain version of csrc/expsum_sup.cu) on the CPU: against the host
longdouble function (deflate.expsum_sup_error) on the coefficient rows the
solvers select, exp_dd against longdouble and against a 40-digit decimal
exp, the kernel's constants against the plain version's, the wrapper's
checks, and solve_deflated's CPU path left on the host function."""
import math
import re
from decimal import Decimal, getcontext
from fractions import Fraction

import numpy as np
import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu_torch import deflate
from tensorkrylov_tpu_torch.coeffs.tables import load_tables, select_bh
from tensorkrylov_tpu_torch.ops import _build, expsum
from tensorkrylov_tpu_torch.ops.expsum import exp_dd, expsum_sup_error_dd

# one intra-op thread per test worker (see test_torch_solve.py)
torch.set_num_threads(1)

# (κ, the coefficient tolerance) of the rows: a κ = 1e2 solve's tol/κ, a plain tol, the deflated cells'
# 0.5·tol/κ at the flagship's κ ≈ 1.05e6 and around it
ROWS = [(1e2, 1e-8 / 1e2), (1e3, 1e-10), (1e6, 0.5e-8 / 1e6), (1.05e6, 0.5e-8 / 1.05e6), (1e7, 0.5e-8 / 1e7)]
GRID = 4001     # the plain version's cost is ~0.1 ms a point here; the card's tests take the full grid
ABS, REL = 1e-17, 1e-8


@pytest.fixture(scope="module")
def tables():
    return load_tables()


def _row(tables, kappa, tol):
    return select_bh(torch.tensor(kappa, dtype=torch.float64), tol, tables)


@pytest.mark.parametrize("kappa,tol", ROWS)
def test_plain_matches_host_longdouble(tables, kappa, tol):
    co = _row(tables, kappa, tol)
    ref = deflate.expsum_sup_error(co.omega, co.alpha, kappa, GRID)
    got = expsum_sup_error_dd(co.omega, co.alpha, kappa, GRID)
    assert 1e-10 < ref < 1e-6
    assert abs(got - ref) <= ABS and abs(got - ref) <= REL * ref


@pytest.mark.parametrize("n_grid", [1, 2, 255, 257])
def test_plain_matches_host_on_ragged_grids(tables, n_grid):
    kappa, tol = ROWS[3]
    co = _row(tables, kappa, tol)
    ref = deflate.expsum_sup_error(co.omega, co.alpha, kappa, n_grid)
    got = expsum_sup_error_dd(co.omega, co.alpha, kappa, n_grid)
    # n_grid = 1 is x = 1 alone, where 1 − g(1) is ~3e-15: longdouble's ~1e-19 is all the relative error there
    assert abs(got - ref) <= ABS and (n_grid == 1 or abs(got - ref) <= REL * ref)


def test_zero_terms_are_left_out(tables):
    """A row padded past the tables' 63 terms with zeros (tmax > 63) gives the
    same bits; no term at all gives |1 − 0| = 1, as the host function."""
    kappa, tol = ROWS[3]
    co = _row(tables, kappa, tol)
    got = expsum_sup_error_dd(co.omega, co.alpha, kappa, 301)
    pad = torch.nn.functional.pad
    assert expsum_sup_error_dd(pad(co.omega, (0, 40)), pad(co.alpha, (0, 40)), kappa, 301) == got
    zeros = torch.zeros(5, dtype=torch.float64)
    assert expsum_sup_error_dd(zeros, zeros + 1.0, kappa, 301) == 1.0 == deflate.expsum_sup_error(
        zeros, zeros + 1.0, kappa, 301)


def _ld(hi, lo):
    return hi.numpy().astype(np.longdouble) + lo.numpy().astype(np.longdouble)


def test_exp_dd_against_longdouble():
    """Over [−745, 0]: within longdouble's own rounding, or within two of the
    smallest subnormal steps where the pair's low part (or the value) lies in
    f64's subnormal range."""
    a = np.concatenate([np.linspace(-745.0, 0.0, 20001),
                        -745.0 * np.random.default_rng(0).random(20000)])
    hi, lo = exp_dd(torch.tensor(a), torch.zeros(a.size, dtype=torch.float64))
    ref = np.exp(a.astype(np.longdouble))
    err = np.abs(_ld(hi, lo) - ref)
    assert np.all(err <= np.maximum(4 * np.finfo(np.longdouble).eps * ref, 2.0 ** -1073))
    assert np.count_nonzero(ref < np.finfo(np.float64).tiny) > 1000


def test_exp_dd_to_1e_28():
    """Against a 40-digit decimal exp of the exact df64 argument: the grid's
    points (a in [0, log 1e7]) and the terms' exponents down to e^a ~ 1e-287,
    below which the pair's low part reaches f64's subnormal range and its
    relative precision falls (the absolute error stays under 1e-320)."""
    getcontext().prec = 40
    rng = np.random.default_rng(1)
    ah = np.concatenate([np.linspace(-660.0, 16.2, 401), -660.0 * rng.random(200), 16.2 * rng.random(200)])
    al = ah * 1e-17 * rng.standard_normal(ah.size)
    hi, lo = exp_dd(torch.tensor(ah), torch.tensor(al))
    worst = 0.0
    for a_h, a_l, e_h, e_l in zip(ah.tolist(), al.tolist(), hi.tolist(), lo.tolist()):
        ref = (Decimal(a_h) + Decimal(a_l)).exp()
        worst = max(worst, float(abs(Decimal(e_h) + Decimal(e_l) - ref) / ref))
    assert worst <= 1e-28


def test_constants_are_exact_and_the_kernels():
    """ln 2 and 1/3! .. 1/8! as df64 pairs rounded from their exact values, and
    the same hex literals, in the same order, in csrc/expsum_sup.cu."""
    getcontext().prec = 60
    ln2 = Decimal(2).ln()
    hi, lo = expsum._LN2
    assert hi == float(ln2) and lo == float(ln2 - Decimal(hi))
    for n, (h, l_) in zip(range(3, 9), expsum._INV_FACT):
        f = Fraction(1, math.factorial(n))
        assert h == float(f) and l_ == float(f - Fraction(h))
    src = (_build.CSRC / "expsum_sup.cu").read_text()
    lits = [float.fromhex(x) for x in re.findall(r"-?0x[0-9a-f]+\.[0-9a-f]+p[-+]?\d+", src)]
    assert lits == [expsum._INV_LN2, *expsum._LN2, *(h for h, _ in expsum._INV_FACT),
                    *(l_ for _, l_ in expsum._INV_FACT)]


def test_wrapper_rejects_bad_input(tables):
    co = _row(tables, *ROWS[3])
    om, al = co.omega, co.alpha
    with pytest.raises(TypeError):
        expsum_sup_error_dd(om.float(), al, 1e6)
    with pytest.raises(TypeError):
        expsum_sup_error_dd(om.numpy(), al, 1e6)
    with pytest.raises(TypeError):
        expsum_sup_error_dd(om[None], al[None], 1e6)
    with pytest.raises(ValueError, match="one length"):
        expsum_sup_error_dd(om, al[:-1], 1e6)
    many = torch.ones(64, dtype=torch.float64)
    with pytest.raises(ValueError, match="at most 63"):
        expsum_sup_error_dd(many, many, 1e6)
    with pytest.raises(ValueError, match="non-negative"):
        expsum_sup_error_dd(om, -al, 1e6)
    for kappa in (math.inf, 0.0, 1e301):
        with pytest.raises(ValueError, match="kappa"):
            expsum_sup_error_dd(om, al, kappa)
    with pytest.raises(ValueError, match="n_grid"):
        expsum_sup_error_dd(om, al, 1e6, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        expsum_sup_error_dd(om, al, 1e6, 11, device="meta")


def test_ops_count_from_the_inputs(tables):
    """Every pair counted at κ = 1 (x = 1 everywhere); pairs past the skip
    threshold not counted."""
    per_point = expsum.expsum_sup_ops(torch.zeros(1, dtype=torch.float64), torch.ones(1, dtype=torch.float64), 1.0,
                                      10)
    assert per_point == 10 * (8 + 605 + 10 + 10)
    one = torch.ones(3, dtype=torch.float64)
    assert expsum.expsum_sup_ops(one, one, 1.0, 10) == per_point + 30 * (8 + 605 + 8 + 20)
    assert expsum.expsum_sup_ops(one, one * 1e3, 1.0, 10) == per_point


def test_cpu_solve_deflated_keeps_the_host_function(monkeypatch):
    """On a CPU operator solve_deflated's expsum_sup is the host longdouble
    function of its row, bit for bit, and the df64 wrapper is not called."""
    def refuse(*args, **kwargs):
        raise AssertionError("expsum_sup_error_dd called on a CPU operator")

    monkeypatch.setattr(deflate, "expsum_sup_error_dd", refuse)
    op = tkt.laplace(3, 30, shift=50.0, device="cpu")
    cfg = tkt.SolverConfig(kmax=30, tol=1e-7)
    res = tkt.solve_deflated(op, tkt.random_rhs(3, 30, seed=7), cfg, m=6, checkpoints=[8, 16, 24, 30])
    kappa = res.lambda_max / res.lambda_min
    coeff_tol = 0.5 * cfg.tol / kappa if cfg.coeff_tol_scale == "kappa" else 0.5 * cfg.tol
    co = select_bh(torch.tensor(kappa, dtype=cfg.proj_dtype), coeff_tol, load_tables(dtype=cfg.proj_dtype),
                   cfg.tmax, cfg.bh_row_select)
    assert res.expsum_sup == deflate.expsum_sup_error(co.omega, co.alpha, kappa)
    assert res.expsum_rank == int(co.rank)
