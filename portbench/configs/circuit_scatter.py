"""Generator of the circuit-simulation surrogate at scircuit's size: a
nodal conductance matrix with power-law row lengths (a few near-dense power
and ground rows), columns scattered over the whole matrix, negative
conductances off the diagonal and a diagonal of the row's conductance sum
plus one to ground.  Structurally nonsymmetric.

A frozen copy of ``sparsemat_tpu_torch/matgen.py`` ``circuit_scatter``,
scaled by the configuration's ``scale`` (2e-2, as ``chip_smoke.py`` and
``bench.py`` config 4a scale it): the benchmark's operator does not move
when the program's generators do.  The operator is one matrix, drawn from
the configuration's ``matrix_seed`` (0, the one that ``bench.py`` and
``chip_smoke.py`` solve); a run's seed draws only its right-hand sides.
"""

import numpy as np
import scipy.sparse as sp


def circuit_scatter(n: int = 170_998, mean_deg: float = 5.6, zipf_a: float = 2.1,
                    seed: int = 0, dtype=np.float32) -> sp.csr_matrix:
    """scircuit-class surrogate: Zipf-distributed row degrees (clipped at
    n/50, scaled to ``mean_deg``), each off-diagonal target uniform over
    all columns, conductances uniform in [0.1, 2)."""
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


def triplets(cfg, seed):
    """(rows, cols, vals, shape) of the configuration ``cfg``: the scaled
    operator's entries in CSR order.  ``seed``, the run's, is not used: the
    operator is the same in every run."""
    dtype = np.dtype(cfg["dtype"])
    m = (circuit_scatter(n=int(cfg["n"]), mean_deg=float(cfg["mean_deg"]),
                         zipf_a=float(cfg["zipf_a"]), seed=int(cfg["matrix_seed"]),
                         dtype=dtype)
         * dtype.type(cfg["scale"])).tocsr()
    m.sort_indices()
    m = m.tocoo()
    return m.row.astype(np.int64), m.col.astype(np.int64), m.data, m.shape
