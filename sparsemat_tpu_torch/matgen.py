"""Test and benchmark matrix generators (host-side, deterministic): a copy
of ``sparsemat_tpu/matgen.py``.  That module is numpy + scipy only, but its
package's import loads JAX, which the port never does.  A test holds the
copies equal to the originals.

(a) a genuine finite-element assembly — a P1 triangular stiffness matrix
built from per-element matrices, the construction that produces matrices
like cant/pwtk — and (b) structurally faithful surrogates of the published
shape statistics of pwtk (dof-blocked bands with a mixed nnz/row
distribution) and scircuit (power-law global scatter).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def fem_stiffness_p1(nx: int, ny: int, dtype=np.float64) -> sp.csr_matrix:
    """P1 (linear triangle) stiffness matrix for −Δu on an (nx × ny)-cell
    unit square, assembled element-by-element — a real FEM matrix, not a
    stencil shortcut: each cell is split into two triangles and each
    triangle contributes the classic 3×3 element matrix
    K_e[a,b] = (∇φ_a · ∇φ_b) |T|.

    Symmetric positive definite after Dirichlet regularization (identity
    rows would break symmetry; instead the boundary penalty adds a large
    diagonal).  ((nx+1)(ny+1) rows, ~7 nnz/row interior.)
    """
    nvx, nvy = nx + 1, ny + 1
    n = nvx * nvy
    hx, hy = 1.0 / nx, 1.0 / ny

    def vid(ix, iy):
        return iy * nvx + ix

    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = vid(ix, iy).ravel()
    v10 = vid(ix + 1, iy).ravel()
    v01 = vid(ix, iy + 1).ravel()
    v11 = vid(ix + 1, iy + 1).ravel()

    # lower triangle (v00, v10, v11) and upper triangle (v00, v11, v01);
    # element stiffness from the gradient formula K_e = |T| Bᵀ B with
    # B the constant P1 gradient matrix of each triangle
    def elem_matrix(p0, p1, p2):
        x = np.array([p0[0], p1[0], p2[0]])
        y = np.array([p0[1], p1[1], p2[1]])
        area = 0.5 * abs((x[1] - x[0]) * (y[2] - y[0])
                         - (x[2] - x[0]) * (y[1] - y[0]))
        b = np.array([y[1] - y[2], y[2] - y[0], y[0] - y[1]])
        c = np.array([x[2] - x[1], x[0] - x[2], x[1] - x[0]])
        return (np.outer(b, b) + np.outer(c, c)) / (4.0 * area)

    k_lo = elem_matrix((0, 0), (hx, 0), (hx, hy))
    k_up = elem_matrix((0, 0), (hx, hy), (0, hy))

    rows, cols, vals = [], [], []
    for tri, ke in (((v00, v10, v11), k_lo), ((v00, v11, v01), k_up)):
        for a in range(3):
            for b in range(3):
                rows.append(tri[a])
                cols.append(tri[b])
                vals.append(np.full(tri[a].shape, ke[a, b]))
    A = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)).tocsr()
    A.sum_duplicates()

    # Dirichlet penalty on the boundary (keeps symmetry + SPD)
    bx, by = np.meshgrid(np.arange(nvx), np.arange(nvy), indexing="ij")
    boundary = ((bx == 0) | (bx == nx) | (by == 0) | (by == ny)).ravel()
    ids = vid(bx, by).ravel()[boundary]
    pen = sp.coo_matrix((np.full(ids.size, 1e6), (ids, ids)), shape=(n, n))
    return (A + pen).tocsr().astype(dtype)


def fem_block_band(n_nodes: int = 72_640, dof: int = 3, mean_deg: int = 8,
                   bandwidth: int = 600, seed: int = 0,
                   dtype=np.float32) -> sp.csr_matrix:
    """pwtk/cant-class surrogate: a dof-blocked symmetric band matrix with a
    *mixed* nnz/row distribution.

    Structure model (matches the published pwtk stats: 217,918 rows = 72,640
    nodes × 3 dof, ~11.5M nnz ≈ 53 nnz/row, bounded band): each node
    initiates ~Poisson(mean_deg) couplings to neighbors within ±bandwidth
    node indices (symmetrization ≈ doubles the degree); every coupling is a
    dense dof×dof block.  Row degrees therefore vary node-to-node (the
    "mixed distributions" BASELINE config 4 asks for) while the column span
    stays bounded — the FEM regime SlabELL targets.
    """
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
    # strong dof-blocked diagonal (diagonal dominance ⇒ SPD-ish, CG-friendly)
    n = n_nodes * dof
    drows = np.arange(n, dtype=np.int64)
    dvals = np.full(n, 4.0 * mean_deg * 0.1, dtype)
    A = sp.coo_matrix(
        (np.concatenate([vals, dvals]),
         (np.concatenate([rows, drows]), np.concatenate([cols, drows]))),
        shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A.astype(dtype)


def circuit_scatter(n: int = 170_998, mean_deg: float = 5.6, zipf_a: float = 2.1,
                    seed: int = 0, dtype=np.float32) -> sp.csr_matrix:
    """scircuit-class surrogate: power-law degree distribution with GLOBAL
    column scatter (unbounded span — the WELL regime).

    Matches the published scircuit stats (170,998 rows, ~959k nnz ≈ 5.6
    nnz/row, a few near-dense rows from power/ground nets): degrees are
    Zipf-distributed (clipped), targets are uniform over all columns, the
    diagonal is present, and values are conductance-like (negative
    off-diagonals, row-sum-dominant diagonal).
    """
    rng = np.random.default_rng(seed)
    deg = rng.zipf(zipf_a, n).clip(1, n // 50)
    # scale to the requested mean without disturbing the tail shape
    deg = np.maximum((deg * (mean_deg - 1) / max(deg.mean(), 1e-9)), 1).astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = rng.integers(0, n, size=src.size)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    g = rng.uniform(0.1, 2.0, size=src.size).astype(dtype)
    off = sp.coo_matrix((-g, (src, dst)), shape=(n, n)).tocsr()
    off.sum_duplicates()
    rowsum = -np.asarray(off.sum(axis=1)).ravel()
    diag = sp.diags(rowsum + 1.0, 0, shape=(n, n), format="csr", dtype=dtype)
    return (off + diag).tocsr().astype(dtype)
