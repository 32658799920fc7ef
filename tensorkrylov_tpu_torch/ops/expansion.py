"""Error-free f32 expansion arithmetic: counterpart of ``tensorkrylov_tpu/ops/expansion.py``.

A value is an unevaluated sum hi + md + lo of f32 tensors (a ``Triple``,
about 2^-71 relative after ``renorm3``); a pair (hi, lo) is the 48-bit
storage form of the recording solvers' basis (``df64_core.py``,
``block_recorded.py``). The algorithms are the textbook ones: Knuth's TwoSum,
Dekker's split and TwoProduct, Priest's renormalization. ``two_sum`` and
``two_prod`` also take f64 tensors: the compensated Gram of ``utils/cp.py``
and the double-double sup error of ``ops/expsum.py`` are built on them.

Every step is its own rounded tensor op. PyTorch's eager ops round one at a
time on the CPU and on the card, so the error-free transforms hold exactly on
both (``eft_selfcheck`` measures it: defects of 0). Nothing here may pass
through an op that fuses or contracts two roundings (``torch.sub(...,
alpha=)``, ``addcmul``, ``addcdiv``, ``lerp``), through ``torch.compile`` or
``torch.jit.script``, or through an f32 GEMM (which may run in TF32). The JAX
package's optimization-barrier shield (``_shield``, ``TK_EFT_SHIELD``) guards
against XLA's rewrites of these chains and has no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "Triple", "two_sum", "two_prod", "renorm3", "triple_from_f64",
    "triple_to_f64", "pair_from_f64", "triple_add", "triple_add_pair_prod",
    "triple_scale_pair", "triple_sub_f64", "triple_scale_f64",
    "triple_round_pair", "eft_selfcheck", "triple_neg", "triple_sub",
    "pair_scale_f64", "triple_spmv_pairs",
]


class Triple(NamedTuple):
    """Unevaluated f32 sum hi + md + lo (~2^-71 relative after renorm3)."""

    hi: torch.Tensor
    md: torch.Tensor
    lo: torch.Tensor


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):
    """Dekker FastTwoSum: exact when |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


# Veltkamp's splitters: 2^12 + 1 for f32, 2^27 + 1 for f64
_SPLIT = {torch.float32: 4097.0, torch.float64: 134217729.0}


def two_prod(a, b):
    """Dekker TwoProduct: p + e == a * b exactly, without an FMA, for an f32
    or f64 tensor a and a tensor or float b of a's precision."""
    p = a * b
    split = _SPLIT[a.dtype]
    ca, cb = split * a, split * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def renorm3(c0, c1, c2, c3=None) -> Triple:
    """Renormalize 3 (or 4) unordered components into a canonical Triple:
    a bottom-up TwoSum distillation (exact), then a top-down canonicalization.
    The result equals the exact input sum to within ~2^-72 of the largest
    component (absolute), the model the solvers' η bound consumes."""
    t3 = None
    if c3 is not None:
        c2, t3 = two_sum(c2, c3)
    t1, r2 = two_sum(c1, c2)
    t0, r1 = two_sum(c0, t1)
    hi, u = _fast_two_sum(t0, r1)
    md, lo = two_sum(u, r2 if t3 is None else r2 + t3)
    hi, md = _fast_two_sum(hi, md)
    md, lo = _fast_two_sum(md, lo)
    return Triple(hi, md, lo)


def _split3(x):
    """f64 → three f32 components whose sum is x exactly."""
    hi = x.to(torch.float32)
    r = x - hi.to(x.dtype)
    md = r.to(torch.float32)
    return hi, md, (r - md.to(x.dtype)).to(torch.float32)


def triple_from_f64(x) -> Triple:
    """Exact f64 → Triple (f64 has 53 bits; three f32 carry up to 72)."""
    return Triple(*_split3(x))


def triple_to_f64(t: Triple):
    """The value rounded to f64."""
    return t.lo.to(torch.float64) + t.md.to(torch.float64) + t.hi.to(torch.float64)


def pair_from_f64(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """f64 → (hi, lo) f32 pair (48 bits; the storage form of the recording
    solvers' basis and coefficients)."""
    hi = x.to(torch.float32)
    return hi, (x - hi.to(x.dtype)).to(torch.float32)


def triple_add(a: Triple, b: Triple) -> Triple:
    """a + b → renormalized triple (error ~2^-71 of the result)."""
    s0, e0 = two_sum(a.hi, b.hi)
    s1, e1 = two_sum(a.md, b.md)
    t1, f1 = two_sum(s1, e0)
    return renorm3(s0, t1, ((a.lo + b.lo) + e1) + f1)


def triple_add_pair_prod(z: Triple, ah, al, bh, bl, sign=1.0) -> Triple:
    """z + sign·(ah + al)·(bh + bl) for f32 pairs, the band-times-vector
    step of the recurrence. The three significant cross products are
    expanded exactly; al·bl (~2^-48 of the product) is added in plain f32."""
    p0, e0 = two_prod(ah, bh)
    p1, e1 = two_prod(ah, bl)
    p2, e2 = two_prod(al, bh)
    tail = al * bl + e1 + e2
    s0, f0 = two_sum(z.hi, sign * p0)
    m1, g1 = two_sum(p1, p2)
    m2, g2 = two_sum(m1, e0)
    s1, f1 = two_sum(z.md, sign * m2)
    s2 = z.lo + sign * (tail + g1 + g2)
    t1, h1 = two_sum(s1, f0)
    return renorm3(s0, t1, s2 + f1 + h1)


def _scale_parts(vh, vm, vl, sh, sl, st):
    """(vh + vm + vl)·(sh + sl + st): the significant cross products expanded,
    the rest in the f32 tail (vl, st may be None)."""
    p0, e0 = two_prod(vh, sh)
    p1, e1 = two_prod(vh, sl)
    p2, e2 = two_prod(vm, sh)
    tail = vm * sl
    if vl is not None:
        tail = tail + vl * sh
    tail = tail + e1 + e2
    if st is not None:
        tail = tail + vh * st
    m1, g1 = two_sum(p1, p2)
    m2, g2 = two_sum(m1, e0)
    return renorm3(p0, m2, tail + g1 + g2)


def triple_scale_pair(v: Triple, sh, sl) -> Triple:
    """v·(sh + sl) for a scalar (or broadcastable) f32 pair."""
    return _scale_parts(v.hi, v.md, v.lo, sh, sl, None)


def triple_sub_f64(z: Triple, x) -> Triple:
    """z − x for an f64 tensor x, split exactly into a triple first."""
    return triple_add(z, triple_from_f64(-x))


def triple_scale_f64(v: Triple, s) -> Triple:
    """v·s for an f64 scalar (or broadcastable) s, split exactly into three
    f32 components (a pair split would drop 2^-48·|s|·|v|)."""
    return _scale_parts(v.hi, v.md, v.lo, *_split3(s))


def triple_neg(t: Triple) -> Triple:
    return Triple(-t.hi, -t.md, -t.lo)


def triple_sub(a: Triple, b: Triple) -> Triple:
    return triple_add(a, triple_neg(b))


def pair_scale_f64(vh, vl, s) -> Triple:
    """(vh + vl)·s for an f32 pair and an f64 scalar (broadcastable): the
    β·v_{k-2} and α·v_{k-1} terms of the recurrence."""
    return _scale_parts(vh, vl, None, *_split3(s))


def _shifted(v, off: int):
    """w[..., i] = v[..., i + off], zero where i + off is out of range (the
    port's band convention, ops/banded.py)."""
    if off == 0:
        return v
    n = v.shape[-1]
    w = torch.zeros_like(v)
    lo, hi = max(0, -off), min(n, n - off)
    if lo < hi:
        w[..., lo:hi] = v[..., lo + off:hi + off]
    return w


def triple_spmv_pairs(bands_h, bands_l, offsets, vh, vl) -> Triple:
    """A·v in expansion arithmetic for (d, nb, n) pair bands and a (d, n)
    pair v: ops/banded.spmv's band-by-band multiply-accumulate with every
    product expanded error-free. The result is a Triple."""
    z = Triple(torch.zeros_like(vh), torch.zeros_like(vh), torch.zeros_like(vh))
    for b, off in enumerate(offsets):
        z = triple_add_pair_prod(z, bands_h[:, b], bands_l[:, b], _shifted(vh, off), _shifted(vl, off))
    return z


def triple_round_pair(v: Triple):
    """Triple → storage pair (hi, md') and the dropped remainder as f64:
    ((hi, md'), dropped) with hi + md' + dropped == value exactly."""
    hi, t = _fast_two_sum(v.hi, v.md)
    md, lo = _fast_two_sum(t, v.lo)
    hi2, md2 = _fast_two_sum(hi, md)
    return (hi2, md2), lo.to(torch.float64)


def eft_selfcheck(n: int = 4096, seed: int = 0, device="cpu") -> dict:
    """Measure the exactness of the transforms on `device`: the largest
    defects of standalone TwoSum and TwoProduct ('two_sum', 'two_prod'; 0.0
    is exact) and the relative error of the composed pair-product accumulate
    that the recurrence runs ('composed_acc_rel', against a longdouble
    oracle whose own product rounding, ~1e-19, is its floor). The solvers
    record it as certificate evidence."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 1e-6).astype(np.float32)

    def on(x):
        return torch.as_tensor(x, device=device)

    def host(t):
        return t.cpu().numpy().astype(np.float64)

    s, e = two_sum(on(a), on(b))
    d_sum = float(np.max(np.abs((host(s) + host(e)) - (a.astype(np.float64) + b.astype(np.float64)))))
    p, e2 = two_prod(on(a), on(b))
    d_prod = float(np.max(np.abs((host(p) + host(e2)) - a.astype(np.float64) * b.astype(np.float64))))

    av = rng.standard_normal(n) * 1e5
    bv = rng.standard_normal(n)
    z0 = rng.standard_normal(n)
    t = triple_add_pair_prod(triple_from_f64(on(z0)), *pair_from_f64(on(av)), *pair_from_f64(on(bv)))
    ld = np.longdouble
    xh = np.float32(av); xl = np.float32(av - np.float64(xh))
    yh = np.float32(bv); yl = np.float32(bv - np.float64(yh))
    exact = z0.astype(ld) + (xh.astype(ld) + xl.astype(ld)) * (yh.astype(ld) + yl.astype(ld))
    got = sum(c.cpu().numpy().astype(ld) for c in (t.hi, t.md, t.lo))
    scale = np.maximum(np.abs(exact - z0.astype(ld)), np.abs(z0)).astype(ld)
    d_acc = float(np.max(np.abs(got - exact) / scale))
    return {"two_sum": d_sum, "two_prod": d_prod, "composed_acc_rel": d_acc}
