"""Generator of the finite-element surrogate at pwtk's size: a dof-blocked
symmetric band with a mixed number of entries per row, its diagonal set to
Σ_j≠i |a_ij| + 1 so that it is symmetric and strictly diagonally dominant,
hence SPD.

Frozen copies of ``sparsemat_tpu_torch/matgen.py`` ``fem_block_band`` and of
``chip_smoke.py`` ``fem_triplets`` (without its skew option): the benchmark's
operator does not move when the program's generators do.  The structure and
the values are drawn from the seed.
"""

import numpy as np
import scipy.sparse as sp


def fem_block_band(n_nodes: int = 72_640, dof: int = 3, mean_deg: int = 8,
                   bandwidth: int = 600, seed: int = 0,
                   dtype=np.float32) -> sp.csr_matrix:
    """pwtk/cant-class surrogate: each node initiates ~Poisson(mean_deg)
    couplings to neighbours within ±bandwidth node indices (symmetrization
    about doubles the degree); every coupling is a dense dof×dof block."""
    rng = np.random.default_rng(seed)
    bandwidth = min(bandwidth, n_nodes - 1)  # reflection stays in range
    deg = rng.poisson(mean_deg, n_nodes).clip(1, 4 * mean_deg)
    src = np.repeat(np.arange(n_nodes, dtype=np.int64), deg)
    delta = rng.integers(1, bandwidth + 1, size=src.size)
    sign = rng.integers(0, 2, size=src.size) * 2 - 1
    dst = src + sign * delta
    # reflect at the boundaries (clipping would pile edges onto node 0/n-1)
    dst = np.abs(dst)
    dst = np.where(dst >= n_nodes, 2 * n_nodes - 2 - dst, dst)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # symmetric node graph, deduplicated
    pairs = np.unique(
        np.stack([np.minimum(src, dst), np.maximum(src, dst)], 1), axis=0)
    i, j = pairs[:, 0], pairs[:, 1]
    bvals = rng.standard_normal(i.size).astype(dtype) * 0.1
    # expand node graph to dof×dof blocks (off-diagonal couplings both ways)
    di, dj = np.meshgrid(np.arange(dof), np.arange(dof), indexing="ij")
    di, dj = di.ravel(), dj.ravel()
    rows = np.concatenate([(i[:, None] * dof + di).ravel(),
                           (j[:, None] * dof + di).ravel()])
    cols = np.concatenate([(j[:, None] * dof + dj).ravel(),
                           (i[:, None] * dof + dj).ravel()])
    vals = np.concatenate([np.repeat(bvals, dof * dof)] * 2)
    n = n_nodes * dof
    drows = np.arange(n, dtype=np.int64)
    dvals = np.full(n, 4.0 * mean_deg * 0.1, dtype)
    A = sp.coo_matrix(
        (np.concatenate([vals, dvals]),
         (np.concatenate([rows, drows]), np.concatenate([cols, drows]))),
        shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A.astype(dtype)


def spd_triplets(m):
    """The off-diagonal entries of ``m`` and a diagonal of Σ_j≠i |a_ij| + 1
    (summed in f64, stored in ``m``'s dtype), as triplets."""
    m = m.tocoo()
    n = m.shape[0]
    off = m.row != m.col
    r, c, v = m.row[off].astype(np.int64), m.col[off].astype(np.int64), m.data[off]
    d = np.bincount(r, weights=np.abs(v).astype(np.float64), minlength=n) + 1.0
    i = np.arange(n, dtype=np.int64)
    return (np.concatenate([r, i]), np.concatenate([c, i]),
            np.concatenate([v, d.astype(m.dtype)]))


def triplets(cfg, seed):
    """(rows, cols, vals, shape) of the configuration ``cfg``, drawn from
    ``seed``."""
    m = fem_block_band(n_nodes=int(cfg["n_nodes"]), dof=int(cfg["dof"]),
                       mean_deg=int(cfg["mean_deg"]), bandwidth=int(cfg["bandwidth"]),
                       seed=seed, dtype=np.dtype(cfg["dtype"]))
    rows, cols, vals = spd_triplets(m)
    return rows, cols, vals, m.shape
