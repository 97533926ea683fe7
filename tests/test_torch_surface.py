"""The port's host surface against the JAX package's on the same seeded
inputs: the bilinear form ``inner_prod(mat, l, r)`` at the top level and as
a format method (the vector dot stays ``vectors.inner_prod``); the top-level
names; ``spmv_traffic_bytes`` on every format; and the point lookup
``get`` / ``A[i, j]`` and the entry iteration of every format.

Tolerances: the bilinear form relative to |reference|, 1e-5 in f32 (another
summation order) and 1e-12 in f64.  Byte counts and looked-up values are
equal.  f32 operands are passed explicitly, because ``tests/conftest.py``
turns on JAX's x64 mode.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm

#: every format of both packages, frozen from a CSR
FORMATS = ["dia", "csr", "coo", "ell", "sell", "bsr", "slab", "slab_pack", "slab_stream",
           "strip", "route", "well", "gell"]

#: top-level names of the JAX package that the port does not have yet, each
#: still listed in ROADMAP.md's Queue 1: none left
NOT_PORTED = {}


def jax_ref():
    return pytest.importorskip("sparsemat_tpu")


def banded(n=300, seed=0):
    """Entries within 40 of the diagonal plus a diagonal, rows 100–139
    empty, and two stored entries whose value is zero."""
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, 0.04, random_state=rng, format="coo", dtype=np.float64)
    keep = (np.abs(m.row - m.col) <= 40) & ((m.row < 100) | (m.row >= 140))
    m = sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=(n, n)).tocsr()
    d = np.r_[np.ones(100), np.zeros(40), np.ones(n - 140)]
    m = (m + sp.diags(d, format="csr")).tocsr()
    m.eliminate_zeros()
    m.sort_indices()
    m.data[[3, 50]] = 0.0
    return m


def freeze(pkg, m, fmt):
    csr = pkg.CSR.from_scipy(m)
    if fmt == "bsr":
        return pkg.BSR.from_csr(csr)
    if fmt == "csr":
        return csr
    return getattr(csr, f"to_{fmt}")()


# -- inner_prod ------------------------------------------------------------------

@pytest.mark.parametrize("dt,tol", [(np.float32, 1e-5), (np.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("fmt", ["csr", "dia", "slab_pack", "well"])
def test_inner_prod_matches_reference(fmt, dt, tol):
    import jax.numpy as jnp

    jsm = jax_ref()
    m = banded().astype(dt)
    rng = np.random.default_rng(1)
    l, r = (rng.standard_normal(300).astype(dt) for _ in range(2))
    want = float(jsm.inner_prod(freeze(jsm, m, fmt), jnp.asarray(l), jnp.asarray(r)))
    mat = freeze(tsm, m, fmt)
    got = tsm.inner_prod(mat, torch.from_numpy(l), torch.from_numpy(r))
    assert got.dtype == torch.from_numpy(l).dtype and got.dim() == 0
    assert abs(float(got) - want) <= tol * abs(want)
    assert abs(float(mat.inner_prod(l, r)) - want) <= tol * abs(want)
    assert abs(float(got) - float(l.astype(np.float64) @ (m @ r.astype(np.float64)))) \
        <= tol * abs(want)


def test_vector_dot_stays_in_vectors():
    a = torch.tensor([1.0, 2.0, 3.0])
    assert float(tsm.vectors.inner_prod(a, a)) == 14.0
    with pytest.raises(TypeError):
        tsm.inner_prod(a, a)                      # the top-level name is the bilinear form


# -- the top-level names ------------------------------------------------------------

def test_top_level_names_cover_the_reference():
    jsm = jax_ref()
    missing = {name for name in jsm.__all__ if not hasattr(tsm, name)}
    assert missing == set(NOT_PORTED), sorted(missing ^ set(NOT_PORTED))
    assert set(tsm.__all__) >= set(jsm.__all__) - set(NOT_PORTED)
    for name in ("JacobiPreconditioner", "BlockJacobiPreconditioner"):
        assert getattr(tsm, name) is getattr(tsm.solvers, name)


def test_parallel_names_cover_the_reference():
    from sparsemat_tpu_torch import parallel as tpar

    jpar = pytest.importorskip("sparsemat_tpu.parallel")
    assert set(tpar.__all__) >= set(jpar.__all__)
    assert all(hasattr(tpar, name) for name in jpar.__all__)


# -- spmv_traffic_bytes ----------------------------------------------------------------

@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_spmv_traffic_bytes_equals_reference(fmt, dt):
    jsm = jax_ref()
    m = banded().astype(dt)
    want = freeze(jsm, m, fmt).spmv_traffic_bytes()
    got = freeze(tsm, m, fmt).spmv_traffic_bytes()
    assert isinstance(got, int) and got == want


# -- get / A[i, j] / iteration -----------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_get_and_iteration_match_reference(fmt):
    jsm = jax_ref()
    m = banded().astype(np.float32)
    jmat, tmat = freeze(jsm, m, fmt), freeze(tsm, m, fmt)
    rows = np.repeat(np.arange(300), np.diff(m.indptr))
    stored_zeros = [(int(rows[p]), int(m.indices[p])) for p in (3, 50)]
    points = stored_zeros + [(0, 299), (120, 120), (5, 5), (299, 299),
                             (int(rows[7]), int(m.indices[7]))]
    for i, j in points:              # an absent entry, stored zeros, an empty row, the diagonal
        want = jmat.get(i, j)
        got = tmat.get(i, j)
        assert got == want and tmat[i, j] == jmat[i, j], (i, j)
        assert np.asarray(got).dtype == np.asarray(want).dtype
    got = list(tmat)
    want = list(jmat)
    assert [(i, j) for i, j, _ in got] == [(i, j) for i, j, _ in want]
    np.testing.assert_array_equal([v for _, _, v in got], [v for _, _, v in want])
    assert not any(100 <= i < 140 for i, _, _ in got)            # empty rows are skipped
