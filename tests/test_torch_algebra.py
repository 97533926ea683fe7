"""The port's matrix algebra and SpGEMM against the JAX package's, on the
same seeded numpy inputs: ``add``, ``sub``, ``transpose``, the operators
``A + B``, ``A - B``, ``A.T`` and sparse ``A @ B``, ``is_symmetric``,
``is_sorted``, ``is_sorted_row``, ``extract_row`` and ``spgemm`` on its
one-shot and ESC paths; over CSR, COO (canonical and tail-padded), ELL and
DIA (whose results are COO), square and rectangular, with empty rows and
stored zeros, in f32 and f64 and mixed.

Tolerances: the frozen arrays of ``add``, ``sub`` and ``transpose`` are
equal, values included (they sum at most two values, or only move them).
For SpGEMM the class, the ``nse``, the index arrays and their dtypes are
equal, and the values agree within 1e-6 (f32) or 1e-12 (f64) of max |C|:
the duplicates of a coordinate are summed in another order.  The JAX side
runs eagerly, as its own tests run it.

The JAX package's ESC path indexes A's COO slots with its CSR's entry
numbers, so it is wrong where the two orders differ (an ELL, an unsorted
COO); the port reads A's CSR for both, and is held there to scipy and to
the JAX one-shot path.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import LazyModule, port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch.ops import algebra as talg

jnp = LazyModule("jax.numpy")
jsm = LazyModule("sparsemat_tpu")
jalg = LazyModule("sparsemat_tpu.ops.algebra")

TOL = {np.float32: 1e-6, np.float64: 1e-12}
FORMATS = ["csr", "coo", "coo_padded", "ell", "dia"]
DTYPES = [np.float32, np.float64]
DT_IDS = ["f32", "f64"]
FIELDS = {"CSR": ("indptr", "indices", "data", "row_ids"),
          "COO": ("rows", "cols", "vals"),
          "ELL": ("cols", "vals", "row_nnz")}
VALUE_FIELDS = ("data", "vals")


def rand_sparse(n_rows, n_cols, density, seed, dtype=np.float64, empty_rows=(), zeros=0):
    """Seeded random values on a small grid, rows ``empty_rows`` cleared,
    and ``zeros`` stored entries whose value is 0."""
    m = sp.random(n_rows, n_cols, density=density, format="csr", dtype=np.float64,
                  random_state=np.random.default_rng(seed))
    m.data = np.round(m.data * 8 - 4, 3)
    m.data[m.data == 0] = 0.5
    m = m.tolil()
    for r in empty_rows:
        m[r, :] = 0
    m = m.tocsr()
    m.eliminate_zeros()
    m.data[:zeros] = 0.0
    m.sort_indices()
    return m.astype(dtype)


def structural_nnz(a, b):
    """The coordinates A·B reaches, stored zeros and cancellations included
    (scipy's product drops both)."""
    def ones(m):
        return sp.csr_matrix((np.ones_like(m.data), m.indices, m.indptr), m.shape)

    return (ones(a) @ ones(b)).nnz


def freeze(pkg, m, fmt):
    csr = pkg.CSR.from_scipy(m)
    if fmt == "csr":
        return csr
    if fmt == "coo":
        return csr.to_coo()
    if fmt == "coo_padded":
        return csr.to_coo().with_padding_to(m.nnz + 7)
    return getattr(csr, f"to_{fmt}")()


def both(m, fmt):
    return freeze(jsm, m, fmt), freeze(tsm, m, fmt)


def assert_frozen_equal(j, t, vals_tol=None):
    """Same class and fields, each of the same dtype and shape; index arrays
    equal, values equal or (``vals_tol``) within it of max |values|."""
    name = type(j).__name__
    assert type(t).__name__ == name and t.shape == tuple(j.shape)
    if name == "COO":
        assert t.canonical == j.canonical
    for f in FIELDS[name]:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, (f, a.dtype, b.dtype, a.shape, b.shape)
        if f in VALUE_FIELDS and vals_tol is not None:
            scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
            assert np.abs(a.astype(np.float64) - b).max(initial=0.0) <= vals_tol * scale, f
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


SHAPES = {"square": ((80, 80), (80, 80)), "rect": ((60, 90), (60, 90))}


def operands(shape, dtype, seed=0):
    (ra, ca), (rb, cb) = SHAPES[shape]
    a = rand_sparse(ra, ca, 0.06, seed, dtype, empty_rows=(3, 40), zeros=2)
    b = rand_sparse(rb, cb, 0.06, seed + 1, dtype, empty_rows=(5,), zeros=1)
    return a, b


# -- add / sub / transpose ---------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_add_sub_equal_reference(fmt, shape, dt):
    a, b = operands(shape, dt)
    (ja, ta), (jb, tb) = both(a, fmt), both(b, "csr")
    assert_frozen_equal(jsm.add(ja, jb), tsm.add(ta, tb))
    assert_frozen_equal(jsm.sub(ja, jb), tsm.sub(ta, tb))
    assert_frozen_equal(ja + jb, ta + tb)
    assert_frozen_equal(ja - jb, ta - tb)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_transpose_equals_reference(fmt, shape, dt):
    a, _ = operands(shape, dt)
    ja, ta = both(a, fmt)
    assert_frozen_equal(jsm.transpose(ja), tsm.transpose(ta))
    assert_frozen_equal(ja.T, ta.T)
    assert_frozen_equal(ja.transpose(), ta.transpose())


def test_add_of_different_shapes_and_formats_equals_reference():
    a = rand_sparse(50, 30, 0.1, 3, empty_rows=(7,))
    b = rand_sparse(40, 45, 0.1, 4, zeros=1)
    for fa, fb in (("csr", "coo_padded"), ("coo", "ell"), ("ell", "csr"), ("dia", "coo")):
        (ja, ta), (jb, tb) = both(a, fa), both(b, fb)
        assert_frozen_equal(jsm.add(ja, jb), tsm.add(ta, tb))
        assert_frozen_equal(jsm.sub(jb, ja), tsm.sub(tb, ta))


@pytest.mark.parametrize("dts", [(np.float32, np.float64), (np.float64, np.float32)],
                         ids=["f32+f64", "f64+f32"])
def test_mixed_dtypes_promote_as_reference(dts):
    a = rand_sparse(40, 40, 0.1, 5, dts[0])
    b = rand_sparse(40, 40, 0.1, 6, dts[1])
    (ja, ta), (jb, tb) = both(a, "csr"), both(b, "coo")
    got = tsm.add(ta, tb)
    assert got.dtype == torch.float64
    assert_frozen_equal(jsm.add(ja, jb), got)
    assert_frozen_equal(jsm.spgemm(ja, jb), tsm.spgemm(ta, tb), vals_tol=TOL[np.float32])
    assert_frozen_equal(jsm.spgemm(ja, jb, max_fanout_slots=64),
                        tsm.spgemm(ta, tb, max_fanout_slots=64), vals_tol=TOL[np.float32])


# -- predicates ------------------------------------------------------------------------

def symmetric(n=70, seed=8, dtype=np.float64):
    m = rand_sparse(n, n, 0.05, seed, dtype, empty_rows=(2,))
    return (m + m.T).tocsr()


@pytest.mark.parametrize("fmt", FORMATS)
def test_predicates_equal_reference(fmt):
    s = symmetric()
    s.sort_indices()
    u = s.copy()
    u.data[4] += 1.0                          # perturbed: no longer symmetric
    r = rand_sparse(30, 50, 0.1, 9)           # rectangular: never symmetric
    for m in (s, u, r):
        ja, ta = both(m, fmt)
        for kw in ({}, {"rtol": 1e-3}, {"atol": 2.0}):
            want = bool(jsm.is_symmetric(ja, **kw))
            got = tsm.is_symmetric(ta, **kw)
            assert isinstance(got, torch.Tensor) and got.dim() == 0 and bool(got) == want
        assert bool(tsm.is_sorted(ta)) == bool(jsm.is_sorted(ja)) is True
        for i in (0, 2, 5, m.shape[0] - 1):
            assert bool(tsm.is_sorted_row(ta, i)) == bool(jsm.is_sorted_row(ja, i)) is True
            jv, tv = jsm.extract_row(ja, i), tsm.extract_row(ta, i)
            np.testing.assert_array_equal(tv.indices, np.asarray(jv.indices))
            np.testing.assert_array_equal(tv.vals, np.asarray(jv.vals))
            assert tv.dim == jv.dim
    assert bool(tsm.is_symmetric(both(s, fmt)[1]))
    assert not bool(tsm.is_symmetric(both(u, fmt)[1]))


def test_unsorted_rows_are_detected_as_reference():
    indptr, indices, data = np.array([0, 3, 3, 5]), np.array([4, 1, 2, 0, 3]), np.ones(5)
    jm = jsm.CSR.from_arrays(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(data), (3, 5))
    tm = tsm.CSR.from_arrays(indptr, indices, data, (3, 5))
    assert not bool(tsm.is_sorted(tm)) and not bool(jsm.is_sorted(jm))
    for i in range(3):
        assert bool(tsm.is_sorted_row(tm, i)) == bool(jsm.is_sorted_row(jm, i))
    assert not bool(tsm.is_sorted_row(tm, 0)) and bool(tsm.is_sorted_row(tm, 2))


def test_dimension_error():
    a = rand_sparse(20, 30, 0.1, 1)
    (ja, ta) = both(a, "csr")
    with pytest.raises(jsm.DimensionError):
        jsm.spgemm(ja, ja)
    with pytest.raises(tsm.DimensionError):
        tsm.spgemm(ta, ta)
    with pytest.raises(tsm.DimensionError):
        ta @ ta
    assert issubclass(tsm.DimensionError, ValueError)


# -- SpGEMM ------------------------------------------------------------------------------

GEMM_SHAPES = {"square": ((90, 90), (90, 90)), "rect": ((70, 110), (110, 50))}


def gemm_operands(shape, dtype, seed=10):
    (ra, ca), (rb, cb) = GEMM_SHAPES[shape]
    a = rand_sparse(ra, ca, 0.05, seed, dtype, empty_rows=(1, 33), zeros=2)
    b = rand_sparse(rb, cb, 0.05, seed + 1, dtype, empty_rows=(4,), zeros=1)
    return a, b


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape", sorted(GEMM_SHAPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_spgemm_oneshot_equals_reference(fmt, shape, dt):
    a, b = gemm_operands(shape, dt)
    (ja, ta), (jb, tb) = both(a, fmt), both(b, "csr")
    want = jsm.spgemm(ja, jb)
    assert_frozen_equal(want, tsm.spgemm(ta, tb), vals_tol=TOL[dt])
    assert_frozen_equal(want, ta @ tb, vals_tol=TOL[dt])
    np.testing.assert_allclose(tsm.spgemm(ta, tb).todense().numpy(), (a @ b).toarray(),
                               atol=TOL[dt] * 100)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape", sorted(GEMM_SHAPES))
@pytest.mark.parametrize("fmt", ["csr", "coo", "coo_padded"])
def test_spgemm_esc_equals_reference(fmt, shape, dt):
    """``max_fanout_slots`` below the fan-out sends both packages down the
    ESC path (for A in CSR or in a COO whose slots are the CSR's)."""
    a, b = gemm_operands(shape, dt)
    (ja, ta), (jb, tb) = both(a, fmt), both(b, fmt)
    want = jsm.spgemm(ja, jb, max_fanout_slots=256)
    got = tsm.spgemm(ta, tb, max_fanout_slots=256)
    assert_frozen_equal(want, got, vals_tol=TOL[dt])
    assert got.nse == structural_nnz(a, b)    # every reached coordinate, no padding
    np.testing.assert_allclose(got.todense().numpy(), (a @ b).toarray(), atol=TOL[dt] * 100)


@pytest.mark.parametrize("fmt", ["ell", "coo_unsorted", "dia"])
def test_spgemm_esc_reads_the_csr_of_a(fmt):
    """Where A's COO slots are not its CSR's entries, the port's ESC path
    still gives A·B: equal to scipy, and to the JAX one-shot path after
    pruning padding."""
    a, b = gemm_operands("square", np.float64)
    if fmt == "coo_unsorted":
        c = a.tocoo()
        p = np.random.default_rng(0).permutation(c.nnz)
        ta = tsm.COO.from_arrays(c.row[p].astype(np.int32), c.col[p].astype(np.int32),
                                 c.data[p], a.shape)
        ja = jsm.COO.from_arrays(c.row[p].astype(np.int32), c.col[p].astype(np.int32),
                                 c.data[p], a.shape)
    else:
        ja, ta = both(a, fmt)
    jb, tb = both(b, "csr")
    got = tsm.spgemm(ta, tb, max_fanout_slots=256)
    ref = (a @ b).toarray()
    np.testing.assert_allclose(got.todense().numpy(), ref, atol=1e-12)
    one = jsm.spgemm(ja, jb).to_coo().prune()
    mine = got.to_coo().prune()
    np.testing.assert_array_equal(mine.rows.numpy(), np.asarray(one.rows))
    np.testing.assert_array_equal(mine.cols.numpy(), np.asarray(one.cols))
    np.testing.assert_allclose(mine.vals.numpy(), np.asarray(one.vals), atol=1e-12)


@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_spgemm_esc_multipart_equals_reference(dt):
    """Part sizes far below the fan-out: the parts concatenate into the
    exact product, canonical, equal to the JAX ESC's arrays."""
    n = 200
    m = rand_sparse(n, n, 0.03, 4, dt, empty_rows=(0, 100), zeros=3)
    (ja, ta) = both(m, "csr")
    want = jalg._spgemm_device_esc(ja.to_coo(), ja.to_csr(), (n, n), jnp.dtype(dt),
                                   part_slots=1 << 10)
    tdt = torch.from_numpy(np.zeros(0, dt)).dtype
    got = talg._spgemm_device_esc(ta.to_coo(), ta.to_csr(), (n, n), tdt, part_slots=1 << 10)
    assert_frozen_equal(want, got, vals_tol=TOL[dt])
    assert talg.esc_plan(ta, ta, 1 << 10).n_parts > 3
    key = got.rows.long() * n + got.cols.long()
    assert bool((key[1:] > key[:-1]).all())
    np.testing.assert_allclose(got.todense().numpy(), (m @ m).toarray(), atol=TOL[dt] * 100)
    # the part size moves no bit of the result
    for slots in (1 << 6, 1 << 14, 1 << 27):
        other = talg._spgemm_device_esc(ta.to_coo(), ta, (n, n), tdt, part_slots=slots)
        assert torch.equal(other.rows, got.rows) and torch.equal(other.vals, got.vals)


def test_spgemm_esc_heavy_row_equals_reference():
    """A near-dense row whose fan-out exceeds ``part_slots`` takes a part of
    its own."""
    rng = np.random.default_rng(13)
    n = 300
    m = sp.random(n, n, density=0.01, format="lil", random_state=5, dtype=np.float64)
    m[7, :250] = rng.standard_normal(250)
    m = m.tocsr()
    m.sum_duplicates()
    (ja, ta) = both(m, "csr")
    want = jalg._spgemm_device_esc(ja.to_coo(), ja.to_csr(), (n, n), jnp.dtype(np.float64),
                                   part_slots=64)
    got = talg._spgemm_device_esc(ta.to_coo(), ta.to_csr(), (n, n), torch.float64,
                                  part_slots=64)
    assert_frozen_equal(want, got, vals_tol=1e-12)
    plan = talg.esc_plan(ta, ta, 64)
    heavy = [p for p in range(plan.n_parts) if plan.row_cuts[p] == 7]
    assert heavy and plan.row_cuts[heavy[0] + 1] == 8
    np.testing.assert_allclose(got.todense().numpy(), (m @ m).toarray(), atol=1e-12)


def test_spgemm_chunked_matches_oneshot():
    a = rand_sparse(120, 120, 0.08, 9, np.float32)
    b = rand_sparse(120, 120, 0.08, 10, np.float32)
    (ja, ta), (jb, tb) = both(a, "csr"), both(b, "csr")
    one, esc = tsm.spgemm(ta, tb), tsm.spgemm(ta, tb, max_fanout_slots=512)
    assert type(one) is type(esc) is tsm.CSR
    np.testing.assert_allclose(esc.todense().numpy(), one.todense().numpy(), atol=1e-5)
    assert_frozen_equal(jsm.spgemm(ja, jb, max_fanout_slots=512), esc, vals_tol=1e-6)


def test_spgemm_ell_budget_sends_a_heavy_b_down_esc(monkeypatch):
    """Past ``_SPGEMM_ELL_BUDGET`` both packages take the ESC path even
    with an unlimited fan-out."""
    rng = np.random.default_rng(7)
    n = 300
    m = sp.random(n, n, density=0.01, format="lil", random_state=1, dtype=np.float64)
    m[5, :200] = rng.standard_normal(200)
    m = m.tocsr()
    m.sum_duplicates()
    (ja, ta) = both(m, "csr")
    monkeypatch.setattr("sparsemat_tpu.ops.algebra._SPGEMM_ELL_BUDGET", 64 * 8)
    monkeypatch.setattr(talg, "_SPGEMM_ELL_BUDGET", 64 * 8)
    want, got = jsm.spgemm(ja, ja), tsm.spgemm(ta, ta)
    assert got.nse == structural_nnz(m, m)
    assert_frozen_equal(want, got, vals_tol=1e-12)


@pytest.mark.parametrize("case", ["no entries", "no candidates"])
def test_spgemm_with_nothing_to_expand_equals_reference(case):
    """An empty A, or an A whose columns hit only empty rows of B, gives one
    padding slot on the ESC path and an all-padding result one-shot."""
    b = rand_sparse(20, 25, 0.2, 3, empty_rows=range(10))
    if case == "no entries":
        a = sp.csr_matrix((30, 20))
    else:                                   # A reaches only B's empty rows
        a = sp.hstack([rand_sparse(30, 10, 0.2, 2), sp.csr_matrix((30, 10))]).tocsr()
    (ja, ta), (jb, tb) = both(a, "csr"), both(b, "csr")
    for kw in ({}, {"max_fanout_slots": 0}):
        assert_frozen_equal(jsm.spgemm(ja, jb, **kw), tsm.spgemm(ta, tb, **kw))


def test_spgemm_of_a_b_with_no_entries():
    """The port alone: the reference's one-shot path raises on an empty B
    (its ELL gather has nothing to read); the port's product is all
    padding, nse_A × 1 slots."""
    a = rand_sparse(30, 20, 0.1, 1)
    ta, tb = both(a, "csr")[1], tsm.CSR.from_scipy(sp.csr_matrix((20, 25)))
    c = tsm.spgemm(ta, tb)
    assert c.shape == (30, 25) and c.nse == a.nnz and c.n_non_zero_entries() == 0
    esc = tsm.spgemm(ta, tb, max_fanout_slots=0)
    assert esc.nse == 1 and esc.n_non_zero_entries() == 0


def test_spgemm_n_cols_per_row_b_cuts_as_reference():
    a, b = gemm_operands("square", np.float64)
    (ja, ta), (jb, tb) = both(a, "csr"), both(b, "csr")
    assert_frozen_equal(jsm.spgemm(ja, jb, n_cols_per_row_b=2),
                        tsm.spgemm(ta, tb, n_cols_per_row_b=2), vals_tol=1e-12)


def test_spgemm_prune_drops_cancelled_zeros():
    """The product stores every reached coordinate: a cancellation stays as
    a stored zero until ``prune(keep_zeros=False)`` drops it."""
    a = sp.csr_matrix(np.array([[1.0, 1.0], [0.0, 1.0]]))
    b = sp.csr_matrix(np.array([[1.0, 0.0], [-1.0, 1.0]]))
    for kw in ({}, {"max_fanout_slots": 0}):
        c = tsm.spgemm(both(a, "csr")[1], both(b, "csr")[1], **kw)
        assert c.prune().n_non_zero_entries() == 4 and 0.0 in c.prune().data.tolist()
        pruned = c.prune(keep_zeros=False)
        assert pruned.n_non_zero_entries() == np.count_nonzero((a @ b).toarray()) == 3


def test_spgemm_under_torch_compile_takes_the_eager_path():
    a, b = gemm_operands("square", np.float64)
    ta, tb = both(a, "csr")[1], both(b, "csr")[1]
    eager = tsm.spgemm(ta, tb, max_fanout_slots=256)
    compiled = torch.compile(lambda x, y: tsm.spgemm(x, y, max_fanout_slots=256),
                             backend="eager")(ta, tb)
    for f in FIELDS["CSR"]:
        assert torch.equal(getattr(compiled, f), getattr(eager, f))


# -- on the card (needs a card) ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"max_fanout_slots": 256}], ids=["oneshot", "esc"])
def test_cuda_spgemm_matches_the_cpu_path_and_reruns_bitwise(cuda, kw):
    a, b = gemm_operands("rect", np.float32)
    ca, cb = (tsm.CSR.from_scipy(m, device="cpu") for m in (a, b))
    ga, gb = (tsm.CSR.from_scipy(m, device=cuda) for m in (a, b))
    want, got = tsm.spgemm(ca, cb, **kw), tsm.spgemm(ga, gb, **kw)
    for f in ("indptr", "indices", "row_ids"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
    scale = float(want.data.abs().max())
    assert float((got.data.cpu() - want.data).abs().max()) <= 1e-6 * scale
    again = tsm.spgemm(ga, gb, **kw)
    assert torch.equal(again.data, got.data) and torch.equal(again.indices, got.indices)
    assert_frozen_equal(tsm.add(ca, cb), _cpu(tsm.add(ga, gb)))


@pytest.mark.cuda
def test_cuda_esc_multipart_reruns_bitwise(cuda):
    m = rand_sparse(400, 400, 0.03, 4, np.float32)
    g = tsm.CSR.from_scipy(m, device=cuda)
    one = talg._spgemm_device_esc(g.to_coo(), g, (400, 400), torch.float32, part_slots=1 << 9)
    two = talg._spgemm_device_esc(g.to_coo(), g, (400, 400), torch.float32, part_slots=1 << 20)
    assert torch.equal(one.rows, two.rows) and torch.equal(one.vals, two.vals)
    np.testing.assert_allclose(one.todense().cpu().numpy(), (m @ m).toarray(), atol=1e-4)


def _cpu(csr):
    return tsm.CSR(indptr=csr.indptr.cpu(), indices=csr.indices.cpu(), data=csr.data.cpu(),
                   row_ids=csr.row_ids.cpu(), shape=csr.shape)
