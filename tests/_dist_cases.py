"""The matrices of ``tests/test_dist.py``, shared by the port's
distribution tests and their worker processes (numpy and scipy only, so a
torch-only worker imports it)."""

import numpy as np
import scipy.sparse as sp


def poisson1d(n, dtype=np.float64):
    return sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                    [0, 1, -1], format="csr").astype(dtype)


def poisson2d(n, dtype=np.float32):
    """The 5-point operator on an n × n grid (``tests/_mp_worker.py``)."""
    m = n * n
    off1 = -np.ones(m - 1)
    off1[n - 1::n] = 0.0
    offn = -np.ones(m - n)
    return sp.diags([4.0 * np.ones(m), off1, off1, offn, offn], [0, 1, -1, n, -n],
                    format="csr").astype(dtype)


def random_banded(n, offsets, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return sp.diags([rng.standard_normal(n - abs(o)).astype(dtype) for o in offsets],
                    offsets, shape=(n, n), format="csr")


def stencil27(n):
    """3-D 27-point stencil on an n³ grid."""
    m = n ** 3
    offs, vals = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                off = dz * n * n + dy * n + dx
                offs.append(off)
                vals.append(26.0 if off == 0 else -1.0)
    diags = [np.full(m - abs(o), v, np.float32) for o, v in zip(offs, vals)]
    return sp.diags(diags, offs, shape=(m, m), format="csr")


def skewed(n=1024, halo=4):
    """A band at ±halo whose row 5 also reads 100 columns of the second
    block of eight."""
    m = random_banded(n, [-halo, 0, halo], seed=23).tolil()
    m[5, 128:228] = 1.0
    return m.tocsr()


def scattered_band(n=4096, k=9, band=300, seed=11):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-band, band + 1, size=n * k), 0, n - 1)
    m = sp.csr_matrix((rng.standard_normal(n * k).astype(np.float32), (rows, cols)),
                      shape=(n, n))
    m.sum_duplicates()
    return m


def uneven_slab(n=4000):
    m = sp.random(n, n, density=0.005, format="coo", random_state=3, dtype=np.float32)
    keep = np.abs(m.row - m.col) <= 150
    return sp.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=(n, n))


def random_1000():
    """The halo guard's matrix: entries anywhere."""
    return sp.random(1000, 1000, density=0.01, format="csr", random_state=3,
                     dtype=np.float32)


def random_300(dtype=np.float64):
    rng = np.random.default_rng(4)
    return sp.random(300, 300, density=0.05, random_state=rng, format="csr", dtype=dtype)


def slab_lap(n=8192):
    """4 on the diagonal, −1 at ±1 and ±130: the DistSlab CG operator."""
    return sp.diags([4.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1),
                     -np.ones(n - 130), -np.ones(n - 130)],
                    [0, 1, -1, 130, -130], format="csr").astype(np.float32)


#: name → a builder of the matrix (scipy CSR); ``banded`` ones also freeze to DIA
MATRICES = {
    "band3": lambda: random_banded(240, [-3, -1, 0, 1, 3]),
    "band40": lambda: random_banded(128, [-40, 0, 40]),
    "band130": lambda: random_banded(1000, [-130, 0, 130], seed=5),
    "uneven237": lambda: random_banded(237, [-2, 0, 2]),
    "poisson1d": lambda: poisson1d(4096),
    "poisson2d": lambda: poisson2d(24),
    "stencil27": lambda: stencil27(12),
    "subset257": lambda: random_banded(257, [-40, -3, 0, 3, 40], seed=11).tocsr(),
    "skewed": skewed,
    "random300": random_300,
    "random1000": random_1000,
    "scattered": scattered_band,
    "uneven_slab": uneven_slab,
}
BANDED = ("band3", "band40", "band130", "uneven237", "poisson1d", "poisson2d", "stencil27",
          "subset257")
