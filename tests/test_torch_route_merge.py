"""The RouteStream SpMV's merge-path design against the JAX package on the
same seeded inputs: ``kernels/_rowgroup.py`` ``MergeSplit`` (the
nnz-balanced split) and ``kernels/route.py`` ``route_spmv_walk`` (the
arithmetic of ``csrc/route.cu`` in its order, in plain torch).  A
RouteStream's plan is its CSR (G = 1); the split's tiles hold every row end
and entry once, start where a brute-force merge puts them, and list each
row that spans tiles with its tiles in order; the walk of the split, at
tiles of 8 and 16 items (rows spanning 2 and more tiles) and at the
kernel's own, equals ``route_spmv_ref``, scipy, ``route_spmv_xla`` and the
interpret-mode ``route_spmv_pallas`` on the matrices of test_torch_route.py
and a row of 3,500 entries; bf16 and f16 values are computed in f32; and
the plan holds no padding slot, so an x holding inf or NaN gives the CSR
product's answer.

Tolerances: relative to max|reference|, 1e-5 in f32 and 1e-12 in f64 (the
walk sums each row in merge order, the table halves in the routed order).
f32 operands are passed explicitly, because ``tests/conftest.py`` turns on
JAX's x64 mode.  The JAX package is imported inside the tests.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import matgen
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.kernels import route as kr
from test_torch_route import MATRICES as ROUTE_MATRICES
from test_torch_route import jax_ref, rel_err


def heavy():
    """400×4000 scatter with row 7 holding 3,500 entries (it spans 3 tiles
    at the kernel's 1,536 items) and rows 9 and 100–119 empty."""
    m = sp.random(400, 4000, 0.002, format="lil", dtype=np.float32, random_state=3)
    m[7, :3500] = 1.5
    m[9, :] = 0
    m[100:120, :] = 0
    return m.tocsr()


MATRICES = dict(ROUTE_MATRICES, heavy=heavy)
ITEMS = [8, 16, rg.MERGE_ITEMS]
TOL = {np.float32: 1e-5, np.float64: 1e-12}
_cache = {}


def csr_of(name, dtype=np.float32):
    m = MATRICES[name]().astype(dtype).tocsr()
    m.sort_indices()
    return m


def route_of(name, dtype=np.float32):
    """The port's RouteStream of a matrix, frozen once per (name, dtype)."""
    key = ("port", name, dtype)
    if key not in _cache:
        _cache[key] = tsm.CSR.from_scipy(csr_of(name, dtype)).to_route()
    return _cache[key]


def xla_oracle(name, dtype, x):
    """``route_spmv_xla`` of the JAX package's freeze of the same matrix."""
    import jax.numpy as jnp

    jsm, jkr = jax_ref()
    key = ("jax", name, dtype)
    if key not in _cache:
        _cache[key] = jsm.CSR.from_scipy(csr_of(name, dtype)).to_route()
    return np.asarray(jkr.route_spmv_xla(_cache[key], jnp.asarray(x)))


def brute_merge(indptr):
    """Walk the merge of the row ends with the entries item by item, as
    the kernel's threads do (a row's end goes before entry j once j reaches
    it): the (row, entry) coordinate before each item, and for each item
    whether it is a row end."""
    n_rows, nnz = len(indptr) - 1, int(indptr[-1])
    coords, is_end = [], []
    i = j = 0
    for _ in range(n_rows + nnz):
        coords.append((i, j))
        end = i < n_rows and indptr[i + 1] <= j
        is_end.append(end)
        if end:
            i += 1
        else:
            j += 1
    coords.append((i, j))
    return np.array(coords, np.int64), np.array(is_end, bool)


# -- the plan and the split ---------------------------------------------------------

@pytest.mark.parametrize("name", MATRICES)
def test_plan_of_a_route_stream_is_its_csr(name):
    m = csr_of(name)
    rs = route_of(name)
    plan = rg.plan_of(rs)
    assert plan.group == 1 and plan.shape == m.shape and plan.nnz == m.nnz
    assert plan.n_groups == m.shape[0] and plan.n_union == m.nnz
    np.testing.assert_array_equal(plan.grp_ptr.numpy(), m.indptr)
    np.testing.assert_array_equal(plan.cols.numpy(), m.indices)
    np.testing.assert_array_equal(plan.vals.numpy(), m.data[None, :])
    assert bool((plan.mask == 1).all())              # every union column is an entry
    assert rg.plan_of(rs) is plan and plan.merge is plan.merge
    assert plan.merge.items == rg.MERGE_ITEMS


@pytest.mark.parametrize("items", ITEMS)
@pytest.mark.parametrize("name", MATRICES)
def test_split_covers_the_merge_once(name, items):
    m = csr_of(name)
    n_rows, nnz = m.shape[0], m.nnz
    split = rg.MergeSplit(rg.plan_of(route_of(name)), items)
    total = n_rows + nnz
    assert split.items == items and split.ipt == -(-items // rg.MERGE_THREADS)
    assert split.n_tiles == -(-total // items)
    coords, is_end = brute_merge(m.indptr)
    # the tile starts are where the brute-force merge stands at each diagonal
    diag = np.minimum(np.arange(split.n_tiles + 1) * items, total)
    np.testing.assert_array_equal(split.starts.numpy(), coords[diag])
    # every row end and entry in exactly one tile: tile t holds the ends of
    # rows [r0, r1) and the entries [e0, e1) between its start and the next
    st = split.starts.numpy()
    assert tuple(st[0]) == (0, 0) and tuple(st[-1]) == (n_rows, nnz)
    row_of, entry_of = coords[:-1, 0], coords[:-1, 1]
    np.testing.assert_array_equal(row_of[is_end], np.arange(n_rows))
    np.testing.assert_array_equal(entry_of[~is_end], np.arange(nnz))
    for t in range(split.n_tiles):
        sl = slice(diag[t], diag[t + 1])
        np.testing.assert_array_equal(row_of[sl][is_end[sl]], np.arange(st[t, 0], st[t + 1, 0]))
        np.testing.assert_array_equal(entry_of[sl][~is_end[sl]],
                                      np.arange(st[t, 1], st[t + 1, 1]))
    tile_of_item = np.arange(total) // items
    ends = np.nonzero(is_end)[0]                    # item of each row's end
    # the rows whose items lie in more than one tile, with their tiles in order
    want = []
    slot = 0
    for r in range(n_rows):
        first_item = m.indptr[r] + r                 # its first entry, or its end if empty
        tiles = np.unique(tile_of_item[first_item:ends[r] + 1])
        assert np.array_equal(tiles, np.arange(tiles[0], tiles[-1] + 1))
        if tiles.size > 1:
            want.append((r, tiles[0], tiles.size, slot))
            slot += tiles.size
    got = split.spans.numpy()
    np.testing.assert_array_equal(got, np.array(want, np.int64).reshape(-1, 4))
    assert split.n_span == len(want) and split.n_partial == slot
    assert split.longest == max([w[2] for w in want], default=0)
    # each tile names the spanning row open at its start and at its end
    open0 = np.full(split.n_tiles, -1)
    open1 = np.full(split.n_tiles, -1)
    for s, (_, f, c, _) in enumerate(want):
        open0[f + 1:f + c] = s
        open1[f:f + c - 1] = s
    np.testing.assert_array_equal(split.tile_span.numpy(), np.stack([open0, open1], 1))


def test_split_and_plan_reject_what_the_kernel_does_not_take():
    plan = rg.plan_of(route_of("n300"))
    with pytest.raises(ValueError, match="items a tile"):
        rg.MergeSplit(plan, rg.MERGE_MAX_ITEMS + 1)
    m = csr_of("n300")
    coo = m.tocoo()
    args = (torch.from_numpy(coo.row), torch.from_numpy(coo.col), torch.from_numpy(coo.data),
            m.shape)
    with pytest.raises(ValueError, match="groups of 9"):
        rg.build(*args, group=9)
    with pytest.raises(ValueError, match="it needs 1"):
        rg.MergeSplit(rg.build(*args, group=2))
    assert rg.build(*args, group=1).group == 1


# -- the walk against the references ---------------------------------------------

@pytest.mark.parametrize("items", ITEMS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", MATRICES)
def test_walk_matches_the_references(name, dtype, items):
    m = csr_of(name, dtype)
    rs = route_of(name, dtype)
    plan = rg.plan_of(rs)
    x = np.random.default_rng(21).standard_normal(m.shape[1]).astype(dtype)
    xt = torch.from_numpy(x)
    y = kr.route_spmv_walk(plan, rg.MergeSplit(plan, items), xt)
    assert y.dtype == xt.dtype and y.shape == (m.shape[0],)
    tol = TOL[dtype]
    assert rel_err(y, kr.route_spmv_ref(rs, xt)) < tol
    assert rel_err(y, m @ x) < tol
    assert rel_err(y, xla_oracle(name, dtype, x)) < tol


@pytest.mark.parametrize("name", ["zipf", "two_splits", "heavy"])
def test_walk_matches_pallas_interpret(name):
    import jax.numpy as jnp

    jsm, jkr = jax_ref()
    m = csr_of(name)
    jrs = jsm.CSR.from_scipy(m).to_route()
    plan = rg.plan_of(route_of(name))
    x = np.random.default_rng(22).standard_normal(m.shape[1]).astype(np.float32)
    want = np.asarray(jkr.route_spmv_pallas(jrs, jnp.asarray(x), interpret=True))
    for items in ITEMS:
        got = kr.route_spmv_walk(plan, rg.MergeSplit(plan, items), torch.from_numpy(x))
        assert rel_err(got, want) < 1e-5, items


@pytest.mark.parametrize("items", [8, rg.MERGE_ITEMS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_walk_of_low_precision_values(dtype, items):
    """bf16/f16 values are computed in f32, as the wrapper casts them."""
    import jax.numpy as jnp

    jsm, jkr = jax_ref()
    m = csr_of("zipf")
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jrs = jsm.CSR.from_scipy(m).astype(jdt).to_route()
    rs = tsm.CSR.from_scipy(m).astype(dtype).to_route()
    plan = rg.plan_of(rs)
    assert plan.group == 1 and plan.vals.dtype == torch.float32
    x = np.random.default_rng(23).standard_normal(m.shape[1]).astype(np.float32)
    got = kr.route_spmv_walk(plan, rg.MergeSplit(plan, items), torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert rel_err(got, jkr.route_spmv_xla(jrs, jnp.asarray(x))) < 1e-5
    assert rel_err(got, kr.route_spmv_ref(rs, torch.from_numpy(x))) < 1e-5


@pytest.mark.parametrize("items", [16, rg.MERGE_ITEMS])
def test_walk_on_the_circuit_surrogate(items):
    m = matgen.circuit_scatter(n=4000, seed=2).astype(np.float64).tocsr()
    m.sort_indices()
    rs = tsm.CSR.from_scipy(m).to_route()
    plan = rg.plan_of(rs)
    split = rg.MergeSplit(plan, items)
    assert split.n_span > 0
    x = torch.from_numpy(np.random.default_rng(24).standard_normal(m.shape[1]))
    y = kr.route_spmv_walk(plan, split, x)
    assert rel_err(y, m @ x.numpy()) < 1e-12
    assert rel_err(y, kr.route_spmv_ref(rs, x)) < 1e-12


@pytest.mark.parametrize("items", [8, rg.MERGE_ITEMS])
@pytest.mark.parametrize("name", ["zipf", "stored_zero", "heavy", "rect_300x250"])
def test_walk_reads_no_padding_so_non_finite_x_gives_the_csr_answer(name, items):
    m = csr_of(name, np.float64)
    plan = rg.plan_of(route_of(name, np.float64))
    x = np.random.default_rng(25).standard_normal(m.shape[1])
    x[[0, 3]] = np.inf
    x[5] = np.nan
    got = kr.route_spmv_walk(plan, rg.MergeSplit(plan, items), torch.from_numpy(x)).numpy()
    want = m @ x
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert fin.any() and rel_err(got[fin], want[fin]) < 1e-12
