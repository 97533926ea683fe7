"""The row-group SpMV over the plan (``kernels/_rowgroup.py``: ``SpmvSplit``
and ``spmv_walk``, the order of ``csrc/spmv.cu`` in plain torch) against
the JAX package on the same seeded inputs: the walk of the plan of every
WELL, SlabELL, SlabPack, StripELL and SlabStream of the matrices of
test_torch_well.py, test_torch_slab.py, test_torch_strip.py,
test_torch_slab_stream.py and test_torch_rowgroup.py equals
``well_spmv_xla``, ``slab_spmv_xla``, ``slab_pack_spmv_xla``,
``strip_spmv_xla``, ``slab_stream_spmv_xla``, the interpret-mode
``well_spmv_pallas``, ``slab_pack_spmv_pallas``, ``strip_spmv_pallas`` and
``slab_stream_spmv_pallas``, and scipy; so does the walk forced through
one-column segments (every group of several columns takes the partials
path) and at each sub-warp width; the segment table covers each group
once; a heavy row is cut into many segments; one plan serves a matrix's
SpMV and SpMM, and the five freezes of one CSR have one plan; and a
padding slot reads no x, so an x holding inf or NaN gives a CSR SpMV's
answer.  On a CUDA card, each of the five formats' ``spmv`` against the
walk and scipy, and SlabELL and SlabPack bitwise equal.

Tolerances: relative to max|reference|, 1e-5 in f32 (another summation
order) and 1e-12 in f64.  f32 operands are passed explicitly, because
``tests/conftest.py`` turns on JAX's x64 mode.  The JAX package is imported
inside the tests, so the CUDA tests of this file also run on a machine
without JAX (``-m cuda --noconftest``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import matgen
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.kernels import slab as ksl
from sparsemat_tpu_torch.kernels import strip as ks
from sparsemat_tpu_torch.kernels import well as kw
from sparsemat_tpu_torch.ops import matvec as tmv
from test_torch_rowgroup import MATRICES as RG_MATRICES
from test_torch_rowgroup import fem
from test_torch_slab import MATRICES as SLAB_MATRICES
from test_torch_slab import PACKS
from test_torch_slab_stream import MATRICES as STREAM_MATRICES
from test_torch_strip import LAYOUTS as STRIP_LAYOUTS
from test_torch_strip import MATRICES as STRIP_MATRICES
from test_torch_well import MATRICES as WELL_MATRICES

F32, F64 = (np.float32, 1e-5), (np.float64, 1e-12)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_ref():
    jsm = pytest.importorskip("sparsemat_tpu")
    import jax.numpy as jnp
    from sparsemat_tpu.kernels import spmv as jkv

    return jsm, jnp, jkv


def freezes(kind, m, arg):
    """(port matrix, JAX matrix, JAX XLA oracle) of one freeze of m."""
    jsm, _, jkv = jax_ref()
    tc, jc = tsm.CSR.from_scipy(m), jsm.CSR.from_scipy(m)
    if kind == "well":
        return tc.to_well(k_tile=arg), jc.to_well(k_tile=arg), jkv.well_spmv_xla
    if kind == "slab":
        return tc.to_slab(rb=arg), jc.to_slab(rb=arg), jkv.slab_spmv_xla
    if kind == "strip":
        from sparsemat_tpu.kernels import strip as jks

        kw_ = STRIP_LAYOUTS[arg]
        return tc.to_strip(**kw_), jc.to_strip(**kw_), jks.strip_spmv_xla
    if kind == "stream":
        return tc.to_slab_stream(rb=arg), jc.to_slab_stream(rb=arg), jkv.slab_stream_spmv_xla
    rb, nc, spill = PACKS[arg]
    return (tsm.SlabPack.from_csr(tc, rb=rb, n_classes=nc, spill_frac=spill),
            jsm.SlabPack.from_csr(jc, rb=rb, n_classes=nc, spill_frac=spill),
            jkv.slab_pack_spmv_xla)


def check_walk(kind, m, arg, split=None, seed=0):
    """The walk of the port's plan against the JAX oracle on the JAX freeze
    and against scipy, f32 and f64; ``split(plan)`` overrides the plan's
    own work split."""
    _, jnp, _ = jax_ref()
    for dt, tol in (F32, F64):
        md = m.astype(dt)
        tm, jm, oracle = freezes(kind, md, arg)
        x = np.random.default_rng(seed).standard_normal(m.shape[1]).astype(dt)
        plan = rg.plan_of(tm)
        got = rg.spmv_walk(plan, torch.from_numpy(x), split(plan) if split else None)
        assert got.dtype == torch.from_numpy(x).dtype and got.shape == (m.shape[0],)
        assert rel_err(got, oracle(jm, jnp.asarray(x))) < tol
        assert rel_err(got, md.astype(np.float64) @ x.astype(np.float64)) < tol


# -- the walk against the JAX package's oracles ----------------------------------------

@pytest.mark.parametrize("k_tile", [None, 4])
@pytest.mark.parametrize("name", list(WELL_MATRICES))
def test_walk_matches_well_xla_oracle(name, k_tile):
    check_walk("well", WELL_MATRICES[name], k_tile)


@pytest.mark.parametrize("name,k_tile", [("random_5pct", None), ("k4_overflow", 4),
                                         ("dense_row", 4)])
def test_walk_matches_well_pallas_interpret(name, k_tile):
    jsm, jnp, jkv = jax_ref()
    m = WELL_MATRICES[name]
    x = np.random.default_rng(2).standard_normal(m.shape[1]).astype(np.float32)
    want = jkv.well_spmv_pallas(jsm.CSR.from_scipy(m).to_well(k_tile=k_tile), jnp.asarray(x),
                                interpret=True)
    plan = rg.plan_of(tsm.CSR.from_scipy(m).to_well(k_tile=k_tile))
    assert rel_err(rg.spmv_walk(plan, torch.from_numpy(x)), want) < 1e-5


@pytest.mark.parametrize("rb", [128, 256])
@pytest.mark.parametrize("name", list(SLAB_MATRICES))
def test_walk_matches_slab_xla_oracle(name, rb):
    check_walk("slab", SLAB_MATRICES[name](), rb)


@pytest.mark.parametrize("layout", ["default", "rb128_c3"])
@pytest.mark.parametrize("name", list(SLAB_MATRICES))
def test_walk_matches_slab_pack_xla_oracle(name, layout):
    check_walk("pack", SLAB_MATRICES[name](), layout)


def test_walk_matches_slab_pack_pallas_interpret():
    """Parts, permutation and overflow pack in one plan."""
    jsm, jnp, jkv = jax_ref()
    m = SLAB_MATRICES["mixed_1500"]()
    jp = jsm.SlabPack.from_csr(jsm.CSR.from_scipy(m), rb=128, n_classes=3)
    tp = tsm.SlabPack.from_csr(tsm.CSR.from_scipy(m), rb=128, n_classes=3)
    assert tp.overflow is not None
    x = np.random.default_rng(3).standard_normal(m.shape[1]).astype(np.float32)
    want = jkv.slab_pack_spmv_pallas(jp, jnp.asarray(x), interpret=True)
    assert rel_err(rg.spmv_walk(rg.plan_of(tp), torch.from_numpy(x)), want) < 1e-5


@pytest.mark.parametrize("kind,arg", [("well", None), ("slab", 128), ("pack", "default")])
@pytest.mark.parametrize("name", list(RG_MATRICES))
def test_walk_over_the_rowgroup_matrices(name, kind, arg):
    check_walk(kind, RG_MATRICES[name](), arg)


@pytest.mark.parametrize("kind,arg", [("strip", "default"), ("stream", 128)])
@pytest.mark.parametrize("name", list(RG_MATRICES))
def test_walk_matches_strip_and_slab_stream_xla_oracles(name, kind, arg):
    check_walk(kind, RG_MATRICES[name](), arg)


@pytest.mark.parametrize("name,layout", [("rect_300x9000", "pack2_group1")])
def test_walk_matches_strip_pallas_interpret(name, layout):
    """Class parts, packed lidx and the block permutation in one plan."""
    jsm, jnp, _ = jax_ref()
    from sparsemat_tpu.kernels import strip as jks

    m = STRIP_MATRICES[name]()
    kw_ = STRIP_LAYOUTS[layout]
    x = np.random.default_rng(3).standard_normal(m.shape[1]).astype(np.float32)
    want = jks.strip_spmv_pallas(jsm.CSR.from_scipy(m).to_strip(**kw_), jnp.asarray(x),
                                 interpret=True)
    plan = rg.plan_of(tsm.CSR.from_scipy(m).to_strip(**kw_))
    assert rel_err(rg.spmv_walk(plan, torch.from_numpy(x)), want) < 1e-5


@pytest.mark.parametrize("name,rb", [("mixed_1100", 128)])
def test_walk_matches_slab_stream_pallas_interpret(name, rb):
    """Chunks of one row block summed into it, chunks past n_rows dropped."""
    jsm, jnp, jkv = jax_ref()
    m = STREAM_MATRICES[name]()
    x = np.random.default_rng(23).standard_normal(m.shape[1]).astype(np.float32)
    want = jkv.slab_stream_spmv_pallas(jsm.CSR.from_scipy(m).to_slab_stream(rb=rb),
                                       jnp.asarray(x), interpret=True)
    plan = rg.plan_of(tsm.CSR.from_scipy(m).to_slab_stream(rb=rb))
    assert rel_err(rg.spmv_walk(plan, torch.from_numpy(x)), want) < 1e-5


# -- the work split ----------------------------------------------------------------------

CUT_CASES = [("well", lambda: WELL_MATRICES["random_5pct"], None),
             ("well", lambda: WELL_MATRICES["dense_row"], 4),
             ("slab", SLAB_MATRICES["band_260_k140"], 256),
             ("pack", SLAB_MATRICES["mixed_1500"], "default"),
             ("pack", RG_MATRICES["fem_900"], "rb128_c3")]


@pytest.mark.parametrize("kind,make,arg", CUT_CASES)
def test_one_column_segments_take_the_partials_path(kind, make, arg):
    """seg_cols = 1: a group of k union columns is k segments, and every
    group of several is summed from its partials."""
    m = make()
    plan = rg.plan_of(freezes(kind, m.astype(np.float32), arg)[0])
    split = rg.SpmvSplit(plan, seg_cols=1)
    lens = (plan.grp_ptr[1:] - plan.grp_ptr[:-1]).clamp(min=1)
    assert split.n_seg == int(lens.sum()) and split.n_multi == int((lens > 1).sum()) > 0
    check_walk(kind, m, arg, split=lambda p: rg.SpmvSplit(p, seg_cols=1))


@pytest.mark.parametrize("lanes", rg.LANES)
def test_each_lane_count(lanes):
    """Every width, with and without segments of one lane's pass."""
    for kind, make, arg in CUT_CASES[::2]:
        for seg in (None, lanes):
            check_walk(kind, make(), arg, split=lambda p: rg.SpmvSplit(p, lanes, seg))


def test_lanes_follow_the_mean_group_length():
    """One pass of the lanes covers a group of the mean length."""
    plan = rg.plan_of(tsm.CSR.from_scipy(fem(1500)).to_slab_pack())
    assert plan.group == 3 and 32 < plan.n_union / plan.n_groups <= 64
    assert (plan.spmv.lanes, plan.spmv.seg_cols) == (16, 128)
    circuit = (matgen.circuit_scatter(n=5000, seed=0) * 2e-2).tocsr()
    plan = rg.plan_of(tsm.CSR.from_scipy(circuit).to_well())
    assert plan.group == 1 and (plan.spmv.lanes, plan.spmv.seg_cols) == (4, 32)
    dense = tsm.CSR.from_scipy(sp.csr_matrix(np.ones((64, 400), np.float32))).to_slab()
    assert rg.plan_of(dense).spmv.lanes == 32
    with pytest.raises(ValueError, match="lanes"):
        rg.SpmvSplit(plan, lanes=6)


def test_segment_table_covers_each_group_once():
    """Empty groups, a heavy row and a ragged last group: each group's
    segments are consecutive, tile its union columns, and are tagged by it
    or by its row of ``multi``."""
    m = sp.random(203, 300, 0.01, random_state=np.random.default_rng(5), format="lil",
                  dtype=np.float32)
    m[11, :250] = 1.0                                           # a heavy row
    m[40:90] = 0                                                # empty groups
    plan = rg.plan_of(tsm.CSR.from_scipy(m.tocsr()).to_well())
    split = rg.SpmvSplit(plan, lanes=4, seg_cols=8)
    ptr, tag = split.seg_ptr.numpy(), split.seg_tag.numpy()
    grp_ptr = plan.grp_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == plan.n_union and np.all(np.diff(ptr) >= 0)
    assert np.diff(ptr).max() <= 8
    owner = tag.astype(np.int64)
    for g, first, count, slot in split.multi.numpy():
        assert np.all(tag[first:first + count] == tag[first]) and tag[first] < 0
        owner[first:first + count] = g
        assert ptr[first] == grp_ptr[g] and ptr[first + count] == grp_ptr[g + 1]
    np.testing.assert_array_equal(np.unique(owner), np.arange(plan.n_groups))
    assert np.all(np.diff(owner) >= 0)                          # groups in order, once each
    empty = np.flatnonzero(np.diff(grp_ptr) == 0)
    assert empty.size >= 50 // plan.group - 1
    assert np.all(np.isin(empty, tag))                          # one empty segment each
    assert split.multi.numpy()[:, 3].tolist() == \
        (np.cumsum(split.multi.numpy()[:, 2]) - split.multi.numpy()[:, 2]).tolist()
    x = np.random.default_rng(1).standard_normal(300)
    want = m.tocsr().astype(np.float64) @ x
    assert rel_err(rg.spmv_walk(plan, torch.from_numpy(x), split), want) < 1e-6


def test_a_heavy_row_is_cut_into_many_segments():
    """The circuit surrogate's Zipf rows, through WELL: the heaviest row
    is cut into segments of one sub-warp's two passes."""
    _, jnp, jkv = jax_ref()
    jsm = pytest.importorskip("sparsemat_tpu")
    m = (matgen.circuit_scatter(n=20000, seed=0) * 2e-2).tocsr()
    plan = rg.plan_of(tsm.CSR.from_scipy(m).to_well())
    split = plan.spmv
    heaviest = int(np.diff(m.indptr).max())
    assert heaviest > 10 * split.seg_cols
    assert int(split.multi[:, 2].max()) == -(-heaviest // split.seg_cols)
    x = np.random.default_rng(4).standard_normal(20000)
    assert rel_err(rg.spmv_walk(plan, torch.from_numpy(x)), m.astype(np.float64) @ x) < 1e-12
    x32 = x.astype(np.float32)
    plan32 = rg.plan_of(tsm.CSR.from_scipy(m.astype(np.float32)).to_well())
    want = jkv.well_spmv_xla(jsm.CSR.from_scipy(m.astype(np.float32)).to_well(),
                             jnp.asarray(x32))
    assert rel_err(rg.spmv_walk(plan32, torch.from_numpy(x32)), want) < 1e-5


# -- one plan per matrix -----------------------------------------------------------------

def test_one_plan_serves_spmv_and_spmm(monkeypatch):
    """The launch paths of a SlabELL and a SlabPack hand both kernels the
    one plan cached on the matrix."""
    seen = []
    monkeypatch.setattr(rg, "launch_spmv", lambda plan, x, launches, name: seen.append(plan))
    monkeypatch.setattr(rg, "launch", lambda plan, B, launches, name: seen.append(plan))
    monkeypatch.setattr(tmv, "check_operand", lambda *args: None)
    c = tsm.CSR.from_scipy(SLAB_MATRICES["mixed_1500"]())
    # operands off the CPU take the launch path, whose launches are stubbed
    x, B = torch.empty(1500, device="meta"), torch.empty(1500, 3, device="meta")
    for mat in (c.to_slab(), c.to_slab_pack()):
        plan = rg.plan_of(mat)
        tsm.spmv(mat, x)
        tsm.spmm(mat, B)
        assert seen[-2] is plan and seen[-1] is plan
        assert [k for k in mat.__dict__ if "plan" in k] == ["_rowgroup_plan"]


def test_slab_and_pack_of_one_csr_have_one_plan():
    c = tsm.CSR.from_scipy(RG_MATRICES["fem_900"]())
    a, b, w = (rg.plan_of(mat) for mat in (c.to_slab(), c.to_slab_pack(), c.to_well()))
    for f in ("grp_ptr", "cols", "mask", "vals"):
        assert torch.equal(getattr(a, f), getattr(b, f)) and torch.equal(getattr(a, f),
                                                                         getattr(w, f)), f
    x = torch.randn(900)
    assert torch.equal(rg.spmv_walk(a, x), rg.spmv_walk(b, x))


@pytest.mark.parametrize("name", list(RG_MATRICES))
def test_five_freezes_of_one_csr_have_one_plan(name):
    """StripELL, SlabStream, SlabPack, SlabELL and WELL of one CSR: one plan,
    array for array, so their SpMVs on the card are one launch of one
    kernel over the same arrays."""
    c = tsm.CSR.from_scipy(RG_MATRICES[name]())
    plans = [rg.plan_of(mat) for mat in (c.to_strip(), c.to_slab_stream(), c.to_slab_pack(),
                                         c.to_slab(), c.to_well())]
    for plan in plans[1:]:
        assert (plan.group, plan.shape, plan.nnz) == (plans[0].group, plans[0].shape,
                                                      plans[0].nnz)
        for f in ("grp_ptr", "cols", "mask", "vals"):
            assert torch.equal(getattr(plan, f), getattr(plans[0], f)), f


# -- padding reads no x ------------------------------------------------------------------

def test_walk_gives_a_csr_answer_on_non_finite_x():
    """x holds NaN at a column that only padding slots point at, and inf
    at a stored zero's column: the walk gives scipy's answer (NaN only from
    0 · inf), where the plain versions multiply the padding (NaN)."""
    m = SLAB_MATRICES["stored_zero"]().tocoo()
    free = 128
    keep = m.col != free
    m = sp.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    z = int(np.flatnonzero(m.data == 0)[0])
    x = np.ones(300, np.float32)
    x[int(m.indices[z])] = np.inf
    x[free] = np.nan
    want = m @ x
    assert np.isnan(want).sum() == 1
    c = tsm.CSR.from_scipy(m)
    xt = torch.from_numpy(x)
    for mat, ref in ((c.to_well(), kw.well_spmv_ref), (c.to_slab(rb=128), ksl.slab_spmv_ref),
                     (c.to_slab_pack(), ksl.slab_pack_spmv_ref), (c.to_strip(), ks.strip_spmv_ref),
                     (c.to_slab_stream(rb=128), ksl.slab_stream_spmv_ref)):
        got = rg.spmv_walk(rg.plan_of(mat), xt).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)
        assert np.isnan(ref(mat, xt).numpy()).sum() > 1


# -- the CUDA kernel (needs a card) ------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


FORMATS = {"well": (lambda c: c.to_well(), tsm.spmv, rg.LAUNCHES, "well_spmv"),
            "slab": (lambda c: c.to_slab(rb=128), tsm.spmv, rg.LAUNCHES, "slab_spmv"),
            "pack": (lambda c: c.to_slab_pack(), tsm.spmv, rg.LAUNCHES, "slab_spmv"),
            "strip": (lambda c: c.to_strip(), tsm.spmv, rg.LAUNCHES, "strip_spmv"),
            "stream": (lambda c: c.to_slab_stream(rb=128), tsm.spmv, rg.LAUNCHES,
                       "slab_stream_spmv")}


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, *rg.LANES])
@pytest.mark.parametrize("seg_cols", [None, 1])
@pytest.mark.parametrize("kind", FORMATS)
def test_cuda_kernel_matches_its_walk(cuda, kind, seg_cols, lanes):
    freeze, spmv, launches, name = FORMATS[kind]
    m = (matgen.circuit_scatter(n=3000, seed=1) * 2e-2).tocsr()
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        mat = freeze(tsm.CSR.from_scipy(m, device=cuda)).astype(dt)
        plan = rg.plan_of(mat)
        plan._spmv = rg.SpmvSplit(plan, lanes, seg_cols)
        x = torch.randn(3000, device=cuda, dtype=dt)
        before = launches[name]
        y = spmv(mat, x)
        torch.cuda.synchronize()
        assert launches[name] == before + 1
        assert rel_err(y.cpu(), rg.spmv_walk(plan, x).cpu()) < tol
        assert rel_err(y.cpu(), m.astype(np.float64) @ x.double().cpu().numpy()) < tol
        assert all(torch.equal(spmv(mat, x), y) for _ in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", FORMATS)
def test_cuda_kernel_gives_a_csr_answer_on_non_finite_x(cuda, kind):
    freeze, spmv, _, _ = FORMATS[kind]
    m = SLAB_MATRICES["stored_zero"]().tocoo()
    keep = m.col != 128
    m = sp.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    z = int(np.flatnonzero(m.data == 0)[0])
    x = np.ones(300, np.float32)
    x[int(m.indices[z])] = np.inf
    x[128] = np.nan
    got = spmv(freeze(tsm.CSR.from_scipy(m, device=cuda)), torch.from_numpy(x).to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), m @ x, rtol=1e-5, atol=1e-6, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixed_1500", "fem_700", "empty_rows_tail"])
def test_cuda_slab_and_pack_spmv_agree_bitwise(cuda, name):
    c = tsm.CSR.from_scipy(SLAB_MATRICES[name](), device=cuda)
    x = torch.randn(c.shape[1], device=cuda)
    y = tsm.spmv(c.to_slab(), x)
    assert torch.equal(tsm.spmv(c.to_slab_pack(), x), y)
    assert torch.equal(tsm.spmv(c.to_slab_pack(rb=128, n_classes=3), x), y)
