"""Generator of the 3-D convection–diffusion operator −Δu + β·∇u on the unit
cube with zero Dirichlet boundary, by the 7-point Laplacian and first-order
upwind convection (Saad, *Iterative Methods for Sparse Linear Systems*, 2nd
ed., §2.2 and §2.2.4), as row-major sorted triplets.

N interior points a side, h = 1/(N+1); row i + N·j + N²·k is the node
((i+1)h, (j+1)h, (k+1)h), x fastest.  β(x, y, z) = γ·(e^{xy}, e^{−xy}, 1) at
the row's node.  Diffusion puts 6/h² on the diagonal and −1/h² to each of
the six neighbours; for each component b of β upwinding adds |b|/h to the
diagonal, −max(b, 0)/h to the lower neighbour in that direction and
+min(b, 0)/h to the upper one.  Neighbours outside the grid are dropped (the
boundary's zero values), so every row stays diagonally dominant and the
rows next to the boundary strictly.  The operator has no random part, so
the seed is not read.
"""

import numpy as np


def convdiff_triplets(n, gamma):
    """The n³-row operator as row-major sorted triplets (f64 values)."""
    m = n ** 3
    h = 1.0 / (n + 1)
    r = np.arange(m, dtype=np.int64)
    i, j, k = r % n, (r // n) % n, r // (n * n)
    xy = ((i + 1) * h) * ((j + 1) * h)
    # the velocity's components at each row's node, one per axis x, y, z
    beta = (gamma * np.exp(xy), gamma * np.exp(-xy), np.full(m, float(gamma)))
    del xy
    diag = 6.0 / h ** 2 + sum(np.abs(b) for b in beta) / h

    def lower(b):
        return -1.0 / h ** 2 - np.maximum(b, 0.0) / h

    def upper(b):
        return -1.0 / h ** 2 + np.minimum(b, 0.0) / h

    # (offset, where the neighbour lies inside the grid, value), offsets
    # ascending so that each row's columns come sorted
    stencil = [(-n * n, k > 0, lower(beta[2])), (-n, j > 0, lower(beta[1])),
               (-1, i > 0, lower(beta[0])), (0, np.ones(m, bool), diag),
               (1, i < n - 1, upper(beta[0])), (n, j < n - 1, upper(beta[1])),
               (n * n, k < n - 1, upper(beta[2]))]
    valid = np.stack([v for _, v, _ in stencil], axis=1)
    cols = r[:, None] + np.array([o for o, _, _ in stencil], np.int64)[None, :]
    vals = np.stack([w for _, _, w in stencil], axis=1)
    rows = np.broadcast_to(r[:, None], valid.shape)
    return rows[valid], cols[valid], vals[valid]


def triplets(cfg, seed):
    """(rows, cols, vals, shape) of the configuration ``cfg``."""
    n = int(cfg["grid"])
    rows, cols, vals = convdiff_triplets(n, float(cfg["gamma"]))
    return rows, cols, vals, (n ** 3, n ** 3)
