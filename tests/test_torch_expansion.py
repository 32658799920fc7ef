"""The port's f32 expansion arithmetic (tensorkrylov_tpu_torch/ops/expansion.py)
on the CPU: twins of tests/test_expansion.py, and each function against the
exact value (Python fractions) and against the JAX package's function on the
same inputs.

The port's transforms are exact: each step is its own rounded tensor op, so
TwoSum and TwoProduct have defects of 0 and the triple functions stay within
2^-70 of the exact value. The JAX functions run eagerly (each op rounded
alone, the same op sequence) give the port's bits. Under jit on the CPU the
JAX compiler keeps f32 chains at excess precision and contracts them: they
are pair-grade there (~2^-48, tests/test_expansion.py), so port and jitted
JAX agree to 1e-14 relative, not to the port's 2^-70."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorkrylov_tpu_torch as tkt
from tensorkrylov_tpu.ops import expansion as jex
from tensorkrylov_tpu_torch.ops import expansion as ex

torch.set_num_threads(1)

ld = np.longdouble
EXACT_REL = 2.0**-70       # the port against the exact value, relative to the operands' scale
JAX_REL = 1e-14            # port against the JAX package's CPU-jit result (its pair-grade floor)
LD_FLOOR = 2.5e-19         # a longdouble oracle's own product rounding (tests/test_expansion.py)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _tval(t):
    """Triple → longdouble value (exact)."""
    return sum(np.asarray(c, ld) if not torch.is_tensor(c) else c.numpy().astype(ld) for c in (t.hi, t.md, t.lo))


def _pair(x):
    hi = np.float32(x)
    return hi, np.float32(x - np.float64(hi))


# ---- twins of tests/test_expansion.py (same inputs, same assertions, on the port) ----

def test_two_sum_two_prod_exact():
    rng = np.random.default_rng(42)
    a = rng.standard_normal(4096).astype(np.float32)
    b = (rng.standard_normal(4096) * 1e-5).astype(np.float32)
    s, e = ex.two_sum(_t(a), _t(b))
    np.testing.assert_array_equal(s.numpy().astype(np.float64) + e.numpy().astype(np.float64),
                                  a.astype(np.float64) + b.astype(np.float64))
    p, e2 = ex.two_prod(_t(a), _t(b))
    np.testing.assert_array_equal(p.numpy().astype(np.float64) + e2.numpy().astype(np.float64),
                                  a.astype(np.float64) * b.astype(np.float64))


def test_triple_roundtrip_f64():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000) * np.exp(rng.uniform(-30, 30, 1000))
    np.testing.assert_array_equal(ex.triple_to_f64(ex.triple_from_f64(_t(x))).numpy(), x)


def test_triple_add_relerr():
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal(2000), rng.standard_normal(2000)
    t = ex.triple_add(ex.triple_from_f64(_t(x)), ex.triple_from_f64(_t(y)))
    err = np.abs(_tval(t) - (x.astype(ld) + y.astype(ld)))
    assert float(np.max(err / np.maximum(np.abs(x), np.abs(y)).astype(ld))) < EXACT_REL


def test_triple_add_cancellation():
    """(big + tiny) − big recovers tiny to ~2^-71 of big."""
    rng = np.random.default_rng(3)
    big = np.exp(rng.uniform(0, 10, 1000))
    tiny = rng.standard_normal(1000) * 1e-18
    t = ex.triple_add(ex.triple_add(ex.triple_from_f64(_t(big)), ex.triple_from_f64(_t(tiny))),
                      ex.triple_from_f64(_t(-big)))
    assert float(np.max(np.abs(_tval(t) - tiny.astype(ld)) / big)) < EXACT_REL


def test_pair_prod_accumulate():
    """z + (a pair)·(b pair), the SpMV's step, to the longdouble oracle's floor."""
    rng = np.random.default_rng(4)
    a, b, z0 = rng.standard_normal(2000) * 1e5, rng.standard_normal(2000), rng.standard_normal(2000)
    t = ex.triple_add_pair_prod(ex.triple_from_f64(_t(z0)), *ex.pair_from_f64(_t(a)), *ex.pair_from_f64(_t(b)))
    ah, al = _pair(a)
    bh, bl = _pair(b)
    av, bv = ah.astype(ld) + al.astype(ld), bh.astype(ld) + bl.astype(ld)
    exact = z0.astype(ld) + av * bv
    scale = np.maximum(np.abs(av * bv), np.abs(z0)).astype(ld) + 1e-300
    assert float(np.max(np.abs(_tval(t) - exact) / scale)) < LD_FLOOR


def test_triple_scale_and_sub():
    """Eager torch is the port's one path: the JAX test's eager bound holds
    (its jit bound, 1e-14, is the JAX CPU compiler's)."""
    rng = np.random.default_rng(5)
    v, s, c = rng.standard_normal(1000), np.float64(3.14159e3), rng.standard_normal(1000) * 1e-8
    t = ex.triple_sub_f64(ex.triple_scale_f64(ex.triple_from_f64(_t(v)), torch.tensor(s)), _t(c))
    exact = v.astype(ld) * ld(s) - c.astype(ld)
    scale = np.abs(v.astype(ld) * ld(s)) + np.abs(c)
    assert float(np.max(np.abs(_tval(t) - exact) / scale)) < LD_FLOOR


def test_round_pair_exact_remainder():
    """hi + md + dropped == value exactly; (hi, md) a 48-bit representation."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal(1000) * np.exp(rng.uniform(-10, 10, 1000))
    (hi, md), dropped = ex.triple_round_pair(ex.triple_from_f64(_t(x)))
    recon = hi.numpy().astype(ld) + md.numpy().astype(ld) + dropped.numpy().astype(ld)
    np.testing.assert_array_equal(np.asarray(recon, np.float64), x)
    assert float(np.max(np.abs(dropped.numpy()) / np.abs(x))) < 2.0**-46


def test_triple_spmv_pairs_vs_dense():
    """The expansion SpMV against a longdouble dense oracle of the pair-valued
    operator on the pair-valued v (the port's band convention)."""
    op = tkt.laplace(2, 64, shift=3.0, device="cpu")
    bands = op.bands.numpy()
    bh, bl = _pair(bands)
    v = np.random.default_rng(7).standard_normal((2, 64))
    vh, vl = _pair(v)
    t = ex.triple_spmv_pairs(_t(bh), _t(bl), op.offsets, _t(vh), _t(vl))
    bv, vv = bh.astype(ld) + bl.astype(ld), vh.astype(ld) + vl.astype(ld)
    out = np.zeros((2, 64), ld)
    n = 64
    for bidx, off in enumerate(op.offsets):
        col = bv[:, bidx, :]
        if off == 0:
            out += col * vv
        elif off > 0:
            out[:, : n - off] += col[:, : n - off] * vv[:, off:]
        else:
            out[:, -off:] += col[:, -off:] * vv[:, : n + off]
    assert float(np.max(np.abs(_tval(t) - out) / (np.max(np.abs(out)) + 1.0))) < 1e-18


def test_pair_scale_f64():
    v = np.random.default_rng(8).standard_normal(500) * 1e4
    vh, vl = _pair(v)
    s = np.float64(-1.7320508075688772e2)
    exact = (vh.astype(ld) + vl.astype(ld)) * ld(s)
    t = ex.pair_scale_f64(_t(vh), _t(vl), torch.tensor(s))
    assert float(np.max(np.abs(_tval(t) - exact) / np.abs(exact))) < LD_FLOOR


# ---- the port against the exact value and against the JAX package ----

def test_eft_selfcheck_exact_on_the_cpu():
    """eft_selfcheck on the CPU reads defects of exactly 0, and so do 65,536
    random f32 pairs; the composed accumulate sits at its oracle's floor."""
    chk = ex.eft_selfcheck(device="cpu")
    assert chk["two_sum"] == 0.0 and chk["two_prod"] == 0.0
    assert chk["composed_acc_rel"] < LD_FLOOR
    rng = np.random.default_rng(9)
    a = rng.standard_normal(65536).astype(np.float32)
    b = (rng.standard_normal(65536) * np.exp(rng.uniform(-20, 20, 65536))).astype(np.float32)
    s, e = ex.two_sum(_t(a), _t(b))
    p, f = ex.two_prod(_t(a), _t(b))
    for (x, y), exact in (((s, e), a.astype(ld) + b.astype(ld)), ((p, f), a.astype(ld) * b.astype(ld))):
        assert np.all(x.numpy().astype(ld) + y.numpy().astype(ld) == exact)


N_EXACT = 160   # elements checked against Python fractions (exact rationals)


def _frac(x):
    return [Fraction(float(v)) for v in np.asarray(x, np.float64).ravel()]


def _frac_val(t):
    parts = [_frac(c.numpy() if torch.is_tensor(c) else np.asarray(c)) for c in (t.hi, t.md, t.lo)]
    return [a + b + c for a, b, c in zip(*parts)]


def _cases():
    """name → (port function, JAX function, numpy inputs, exact value function,
    scale function); inputs seeded, each exact value over Fractions."""
    rng = np.random.default_rng(10)
    n = N_EXACT
    x, y = rng.standard_normal(n), rng.standard_normal(n) * np.exp(rng.uniform(-20, 5, n))
    z = rng.standard_normal(n)
    ah, al = _pair(rng.standard_normal(n) * 1e5)
    bh, bl = _pair(rng.standard_normal(n))
    sh, sl = _pair(np.float64(-1.7320508075688772e2))
    s = np.float64(3.14159e3)
    c = rng.standard_normal(n) * 1e-8
    F = _frac
    pa = [u + v for u, v in zip(F(ah), F(al))]
    pb = [u + v for u, v in zip(F(bh), F(bl))]
    big = [max(abs(u), abs(v)) for u, v in zip(F(x), F(y))]
    return {
        "add": (lambda m, x, y: m.triple_add(m.triple_from_f64(x), m.triple_from_f64(y)), (x, y),
                [u + v for u, v in zip(F(x), F(y))], big),
        "sub": (lambda m, x, y: m.triple_sub(m.triple_from_f64(x), m.triple_from_f64(y)), (x, y),
                [u - v for u, v in zip(F(x), F(y))], big),
        "add_pair_prod": (lambda m, z, *p: m.triple_add_pair_prod(m.triple_from_f64(z), *p), (z, ah, al, bh, bl),
                          [w + u * v for w, u, v in zip(F(z), pa, pb)],
                          [max(abs(u * v), abs(w)) for w, u, v in zip(F(z), pa, pb)]),
        "sub_pair_prod": (lambda m, z, *p: m.triple_add_pair_prod(m.triple_from_f64(z), *p, sign=-1.0),
                          (z, ah, al, bh, bl), [w - u * v for w, u, v in zip(F(z), pa, pb)],
                          [max(abs(u * v), abs(w)) for w, u, v in zip(F(z), pa, pb)]),
        "scale_pair": (lambda m, x, h, l: m.triple_scale_pair(m.triple_from_f64(x), h, l), (x, sh, sl),
                       [u * (F(sh)[0] + F(sl)[0]) for u in F(x)], [abs(u * (F(sh)[0] + F(sl)[0])) for u in F(x)]),
        "scale_f64": (lambda m, x, s: m.triple_scale_f64(m.triple_from_f64(x), s), (x, s),
                      [u * F(s)[0] for u in F(x)], [abs(u * F(s)[0]) for u in F(x)]),
        "sub_f64": (lambda m, x, s, c: m.triple_sub_f64(m.triple_scale_f64(m.triple_from_f64(x), s), c), (x, s, c),
                    [u * F(s)[0] - w for u, w in zip(F(x), F(c))],
                    [abs(u * F(s)[0]) + abs(w) for u, w in zip(F(x), F(c))]),
        "pair_scale_f64": (lambda m, h, l, s: m.pair_scale_f64(h, l, s), (ah, al, s),
                           [u * F(s)[0] for u in pa], [abs(u * F(s)[0]) for u in pa]),
    }


CASE_NAMES = ("add", "sub", "add_pair_prod", "sub_pair_prod", "scale_pair", "scale_f64", "sub_f64", "pair_scale_f64")


@pytest.mark.parametrize("name", CASE_NAMES)
def test_triple_function_matches_exact_and_jax(name):
    """Each triple function: the port within 2^-70 of the exact value; equal
    bit for bit to the JAX function run eagerly (each op rounded alone, the
    same op sequence); within the JAX CPU jit's pair-grade 1e-14 of the
    jitted JAX function. The jit computes the sign=-1 accumulate only to f32
    grade (5.6e-8 relative here; the JAX package calls it with sign=+1 only),
    so that case is held to the eager result alone."""
    fn, args, exact, scale = _cases()[name]
    got = fn(ex, *(_t(a) for a in args))
    assert max(float(abs(g - e) / s) for g, e, s in zip(_frac_val(got), exact, scale)) < EXACT_REL
    eager = fn(jex, *(jnp.asarray(a) for a in args))
    for mine, ref in zip(got, eager):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    if name != "sub_pair_prod":
        ref = jax.jit(lambda *a: fn(jex, *a))(*(jnp.asarray(a) for a in args))
        diff = np.abs(_tval(got) - _tval(ref))
        assert float(np.max(diff / np.asarray([float(s) for s in scale], ld))) < JAX_REL


def test_spmv_pairs_and_round_pair_match_exact_and_jax():
    """triple_spmv_pairs on distinct random bands (out-of-range entries zero)
    within 2^-70 of the exact product, within 1e-14 of the JAX package's
    (whose jnp.roll wraps onto zero bands); triple_round_pair's pair equal to
    the JAX package's bit for bit on the same triple."""
    rng = np.random.default_rng(11)
    d, n, offsets = 2, 24, (-2, -1, 0, 1, 2)
    bands = rng.standard_normal((d, len(offsets), n)) * 1e3
    for bidx, off in enumerate(offsets):
        bands[:, bidx, max(0, n - off):] = 0.0
        bands[:, bidx, :max(0, -off)] = 0.0
    bh, bl = _pair(bands)
    vh, vl = _pair(rng.standard_normal((d, n)))
    got = ex.triple_spmv_pairs(_t(bh), _t(bl), offsets, _t(vh), _t(vl))
    B = np.asarray(_frac(bh), object).reshape(bh.shape) + np.asarray(_frac(bl), object).reshape(bh.shape)
    v = np.asarray(_frac(vh), object).reshape(vh.shape) + np.asarray(_frac(vl), object).reshape(vh.shape)
    exact = np.zeros((d, n), object) + Fraction(0)
    for bidx, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        exact[:, lo:hi] += B[:, bidx, lo:hi] * v[:, lo + off:hi + off]
    scale = float(np.max(np.abs(bands))) * float(np.max(np.abs(vh)))
    vals = np.asarray(_frac_val(got), object).reshape(d, n)
    assert max(float(abs(a)) for a in (vals - exact).ravel()) < EXACT_REL * scale
    ref = jax.jit(lambda *a: jex.triple_spmv_pairs(*a[:2], offsets, *a[2:]))(
        *(jnp.asarray(a) for a in (bh, bl, vh, vl)))
    assert float(np.max(np.abs(_tval(got) - _tval(ref)))) < JAX_REL * scale
    (hi, md), dropped = ex.triple_round_pair(got)
    (jhi, jmd), jdropped = jex.triple_round_pair(jex.Triple(*(jnp.asarray(c.numpy()) for c in got)))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(md.numpy(), np.asarray(jmd))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))
