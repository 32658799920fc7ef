"""The compensated Gram's split (ops/gram_dot2.py, csrc/gram_dot2.cu) on the CPU.

The kernel sums each entry's leaves in aligned chunks of 2^q, one node a
chunk, then sums the chunk nodes. The plain-torch twin below does the same,
and equals the plain version bit for bit for any q: the chunked tree is the
plain tree. The kernel itself runs only on the card
(tests/test_torch_cuda.py::test_gram_dot2_kernel_equals_cpu).
"""
import pytest
import torch

from tensorkrylov_tpu_torch.ops import gram_dot2 as gd
from tensorkrylov_tpu_torch.ops.expansion import two_prod, two_sum


def _tree(p, e):
    """Pairwise TwoSum tree over the last axis, a power of two long."""
    while p.shape[-1] > 1:
        s, err = two_sum(p[..., 0::2], p[..., 1::2])
        p, e = s, e[..., 0::2] + e[..., 1::2] + err
    return p[..., 0], e[..., 0]


def _pad(t, length):
    """t zero-padded (+0) along its last axis to length."""
    return torch.nn.functional.pad(t, (0, length - t.shape[-1]))


def chunked_twin(C, q):
    """(hi, lo) of C (d, P, n) as the kernel sums them: leaves in aligned
    chunks of 2^min(q, ⌈log2 n⌉), pads past n (+0, +0), each chunk a complete
    tree; then the chunk nodes, padded to a power of two, in one more."""
    d, P, n = C.shape
    q = min(q, (n - 1).bit_length())
    width = 1 << q
    chunks = -(-n // width)
    i, j = torch.triu_indices(P, P)
    p, e = two_prod(C[:, j, :], C[:, i, :])                        # (d, T, n)
    p, e = (_pad(t, chunks * width).reshape(d, -1, chunks, width) for t in (p, e))
    p, e = _tree(p, e)                                             # (d, T, chunks)
    top = 1 << (chunks - 1).bit_length()
    p, e = _tree(_pad(p, top), _pad(e, top))
    hi = torch.zeros((d, P, P), dtype=C.dtype)
    lo = torch.zeros_like(hi)
    hi[:, i, j], lo[:, i, j] = p, e
    hi[:, j, i], lo[:, j, i] = p, e
    return hi, lo


def _data(n, seed=5):
    """(2, 5, n): log-spaced magnitudes, and in mode 0 a zero row against a
    negative one, whose products are −0 (the tree's pads turn them +0 at
    the levels with an odd count, so the sign tells the trees apart)."""
    g = torch.Generator().manual_seed(seed)
    C = torch.randn((2, 5, n), dtype=torch.float64, generator=g) * torch.logspace(-4, 4, n, dtype=torch.float64)
    C[0, 0] = 0.0
    C[0, 1] = -C[0, 1].abs()
    return C


def _bits(t):
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("q", [2, 5, 12])
@pytest.mark.parametrize("n", [1, 3, 1000, 4096, 4097, 40001])
def test_chunked_tree_is_the_plain_tree(n, q):
    C = _data(n)
    hi, lo = gd.gram_dot2_plain(C)
    thi, tlo = chunked_twin(C, q)
    assert torch.equal(_bits(thi), _bits(hi)) and torch.equal(_bits(tlo), _bits(lo))


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 257, 4097, 131072])
def test_chunk_plan_is_the_twins_split(n):
    """The kernel's plan: chunks of 2^min(LEVELS, ⌈log2 n⌉) leaves, their
    count, and the levels of the tree over them (a power of two ≥ it)."""
    levels, chunks, levels2 = gd.chunk_plan(n)
    assert levels == min(gd.LEVELS, (n - 1).bit_length())
    assert (chunks - 1) << levels < n <= chunks << levels
    assert (1 << levels2) >= chunks and (levels2 == 0 or (1 << (levels2 - 1)) < chunks)
    assert levels + levels2 == (n - 1).bit_length()      # the plain tree's depth


def test_gram_dot2_dispatch_on_the_cpu():
    """A CPU tensor takes the plain version; another device raises."""
    C = _data(33)
    hi, lo = gd.gram_dot2(C)
    phi, plo = gd.gram_dot2_plain(C)
    assert torch.equal(_bits(hi), _bits(phi)) and torch.equal(_bits(lo), _bits(plo))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gd.gram_dot2(torch.empty((1, 2, 3), dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="n >= 1"):
        gd.chunk_plan(0)
