"""setup_s: process start to the first timed solve (imports, the kernel
library, the operator and pool, the deflation basis where the cell has one,
the warm solves)."""


def read(t):
    return t.setup_s
