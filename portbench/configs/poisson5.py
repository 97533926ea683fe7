"""Generator of the 2-D 5-point finite-difference Laplacian on an n × n
interior grid with Dirichlet boundary (Saad, *Iterative Methods for Sparse
Linear Systems*, 2nd ed., §2.2), as row-major sorted triplets.

A frozen copy of ``chip_smoke.py`` ``poisson_triplets``: the benchmark's
operator does not move when the program's scripts do.  The operator has no
random part, so the seed is not read.
"""

import numpy as np


def poisson_triplets(n):
    """The n²-row 5-point Poisson operator as row-major sorted triplets."""
    m = n * n
    i = np.arange(m, dtype=np.int64)
    offs = np.array([-n, -1, 0, 1, n], np.int64)
    valid = np.stack([i >= n, i % n != 0, np.ones(m, bool), i % n != n - 1,
                      i < m - n], axis=1)
    cols = i[:, None] + offs[None, :]
    vals = np.where(offs == 0, 4.0, -1.0)[None, :].repeat(m, 0)
    rows = np.repeat(i, 5).reshape(m, 5)
    return rows[valid], cols[valid], vals[valid]


def triplets(cfg, seed):
    """(rows, cols, vals, shape) of the configuration ``cfg``."""
    n = int(cfg["grid"])
    rows, cols, vals = poisson_triplets(n)
    return rows, cols, vals, (n * n, n * n)
