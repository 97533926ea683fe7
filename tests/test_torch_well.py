"""The port's WELL against the JAX package's on the same inputs: the freeze
gives the same arrays bit for bit (k_tile overflow tiles, dummy tiles of
empty row blocks, stored zeros and nnz = 0 included) and the ``chunks`` the
port's checkpoint writes are the JAX freeze's; the plain SpMV matches the
XLA oracle and the Pallas kernel in interpret mode, as does
``spmv(method='pallas')``; round trips keep stored zeros; the CUDA kernel's
walk over the row-group plan (``kernels/_rowgroup.py``), replayed in torch,
gives A @ x for tiles in and out of row-block order and for groups cut into
many segments; and (on a CUDA card) the kernel matches the plain version.

Tolerances: relative to max|reference|, 1e-5 in f32 (another summation
order), 1e-12 in f64.  The JAX package is imported inside the tests, so the
CUDA tests of this file also run on a machine without JAX (``-m cuda
--noconftest``).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import plan_launches
from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch.formats.well import ROW_BLOCK, chunk_bounds
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.kernels import well as kw

WELL_ARRAYS = ("vals", "lidx", "tile_rows", "tile_wins", "row_cnt")


def reference_cases():
    """tests/test_well.py's matrices, from its one generator in its order."""
    rng = np.random.default_rng(0)
    out = {"random_5pct": sp.random(300, 300, density=0.05, random_state=rng, format="csr",
                                    dtype=np.float32),
           "wide_rect": sp.random(64, 1000, density=0.02, random_state=rng, format="csr",
                                  dtype=np.float32),
           "tall_rect": sp.random(1000, 64, density=0.02, random_state=rng, format="csr",
                                  dtype=np.float32),
           "empty_rows": sp.csr_matrix((np.ones(3, np.float32), ([0, 5, 290], [250, 3, 12])),
                                       shape=(300, 300))}
    dense_row = sp.lil_matrix((40, 256), dtype=np.float32)
    dense_row[7, :] = rng.standard_normal(256)
    dense_row[3, 5] = 2.5
    out["dense_row"] = dense_row.tocsr()
    return out


def stored_zero():
    m = sp.random(200, 300, density=0.04, random_state=7, format="csr", dtype=np.float32)
    m.data[[0, 9, 30]] = 0.0                # stored entries whose value is zero
    return m


def matrices():
    out = reference_cases()
    out["k4_overflow"] = sp.random(64, 128, density=0.2, random_state=np.random.default_rng(3),
                                   format="csr", dtype=np.float32)
    out["stored_zero"] = stored_zero()
    out["nnz0"] = sp.csr_matrix((50, 70), dtype=np.float32)
    return out


MATRICES = matrices()
NAMES = list(MATRICES)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_ref():
    jsm = pytest.importorskip("sparsemat_tpu")
    from sparsemat_tpu.kernels import spmv as jkv

    return jsm, jkv


def wells(m, k_tile=None):
    jsm, _ = jax_ref()
    return (jsm.CSR.from_scipy(m).to_well(k_tile=k_tile),
            tsm.CSR.from_scipy(m).to_well(k_tile=k_tile))


def assert_well_equal(jw, tw):
    assert tw.shape == tuple(jw.shape)
    for f in WELL_ARRAYS:
        a, b = np.asarray(getattr(jw, f)), getattr(tw, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


# -- the freeze ------------------------------------------------------------------

@pytest.mark.parametrize("k_tile", [None, 4])
@pytest.mark.parametrize("name", NAMES)
def test_well_freeze_equals_reference(name, k_tile):
    m = MATRICES[name]
    jw, tw = wells(m, k_tile)
    assert_well_equal(jw, tw)
    assert (tw.nse, tw.n_tiles, tw.k_tile) == (jw.nse, jw.n_tiles, jw.k_tile)
    assert tw.n_non_zero_entries() == int(jw.n_non_zero_entries()) == m.nnz
    assert tw.fill_ratio() == pytest.approx(jw.fill_ratio(), rel=1e-12)
    assert chunk_bounds(tw.host("tile_rows"), tw.n_row_blocks) == jw.chunks


def test_k_tile_cap_makes_overflow_tiles():
    jw, tw = wells(MATRICES["k4_overflow"], 4)
    assert tw.k_tile == 4 and tw.n_tiles > wells(MATRICES["k4_overflow"])[1].n_tiles
    rows = tw.tile_rows.numpy()
    assert np.all(np.diff(rows) >= 0)                    # overflow tiles stay in block order
    assert_well_equal(jw, tw)


def test_freeze_of_f64_and_bf16_values():
    m = MATRICES["random_5pct"].astype(np.float64)
    jw, tw = wells(m)
    assert_well_equal(jw, tw)
    assert tw.dtype == torch.float64
    bf = tsm.CSR.from_scipy(m).astype(torch.bfloat16).to_well()
    assert bf.dtype == torch.bfloat16 and torch.equal(bf.lidx, tw.lidx)
    np.testing.assert_array_equal(bf.vals.float().numpy(),
                                  tw.vals.to(torch.bfloat16).float().numpy())


def test_chunk_bounds_equal_reference_when_split():
    from sparsemat_tpu.formats import well as jwell

    dense = np.random.default_rng(42).standard_normal((64, 512)).astype(np.float32)
    dense[np.random.default_rng(43).random((64, 512)) > 0.1] = 0
    tw = tsm.CSR.from_scipy(sp.csr_matrix(dense)).to_well()
    rows = tw.host("tile_rows")
    for max_tiles in (3, 7, 60_000):
        assert chunk_bounds(rows, 8, max_tiles) == jwell._chunk_bounds(rows, 8, max_tiles)
    assert len(chunk_bounds(rows, 8, 3)) > 1


# -- the plain version against the JAX package's oracle and kernel ----------------

@pytest.mark.parametrize("name", NAMES)
def test_well_spmv_ref_matches_xla_oracle(name):
    import jax.numpy as jnp

    _, jkv = jax_ref()
    m = MATRICES[name]
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        jw, tw = wells(m.astype(dt))
        x = np.random.default_rng(5).standard_normal(m.shape[1]).astype(dt)
        got = kw.well_spmv_ref(tw, torch.from_numpy(x))
        assert got.dtype == torch.from_numpy(x).dtype and got.shape == (m.shape[0],)
        assert rel_err(got, jkv.well_spmv_xla(jw, jnp.asarray(x))) < tol
        assert rel_err(got, m.astype(np.float64) @ x.astype(np.float64)) < tol


@pytest.mark.parametrize("name,k_tile", [("random_5pct", None), ("k4_overflow", 4),
                                         ("empty_rows", None)])
def test_well_spmv_ref_matches_pallas_interpret(name, k_tile):
    import jax.numpy as jnp

    _, jkv = jax_ref()
    m = MATRICES[name]
    jw, tw = wells(m, k_tile)
    x = np.random.default_rng(2).standard_normal(m.shape[1]).astype(np.float32)
    got = kw.well_spmv_ref(tw, torch.from_numpy(x))
    assert rel_err(got, jkv.well_spmv_pallas(jw, jnp.asarray(x), interpret=True)) < 1e-5


def test_spmv_method_pallas_matches_pallas_interpret():
    """The JAX package's ``spmv(method='pallas')`` lowers the TPU kernel even
    on the CPU, so the port's method is held to the kernel in interpret
    mode on the JAX package's own WELL freeze."""
    import jax.numpy as jnp

    jsm, jkv = jax_ref()
    m = MATRICES["wide_rect"]
    x = np.random.default_rng(3).standard_normal(m.shape[1]).astype(np.float32)
    got = tsm.spmv(tsm.CSR.from_scipy(m), torch.from_numpy(x), method="pallas")
    want = jkv.well_spmv_pallas(jsm.CSR.from_scipy(m).to_well(), jnp.asarray(x),
                                interpret=True)
    assert rel_err(got, want) < 1e-5
    tw = tsm.CSR.from_scipy(m).to_well()
    assert torch.equal(tsm.spmv(tw, torch.from_numpy(x), method="pallas"),
                       kw.well_spmv_ref(tw, torch.from_numpy(x)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_matches_xla_oracle(dtype):
    import jax.numpy as jnp

    jsm, jkv = jax_ref()
    m = MATRICES["random_5pct"]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jw = jsm.CSR.from_scipy(m).astype(jdt).to_well()
    tw = tsm.CSR.from_scipy(m).astype(dtype).to_well()
    x = np.random.default_rng(9).standard_normal(300).astype(np.float32)
    got = tsm.spmv(tw, torch.from_numpy(x).to(dtype))
    assert got.dtype == torch.float32
    assert rel_err(got, jkv.well_spmv_xla(jw, jnp.asarray(x).astype(jdt))) < 1e-5


def test_dispatch_and_cpu_wrapper_counts_nothing():
    m = MATRICES["random_5pct"]
    csr = tsm.CSR.from_scipy(m)
    tw = csr.to_well()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(300).astype(np.float32))
    rg.reset_launches()
    y = tsm.spmv(tw, x)
    assert torch.equal(y, kw.well_spmv_ref(tw, x))
    assert torch.equal(tsm.spmv(csr, x, method="well"), y)
    assert torch.equal(tw @ x, y) and torch.equal(tw.mvp(x), y)
    yd, d = tsm.spmv_dot(tw, x)
    assert torch.equal(yd, y) and float(d) == pytest.approx(float(x @ y), rel=1e-6)
    assert rel_err(tsm.spmv_chain(tw, x, 3), m @ (m @ (m @ x.numpy()))) < 1e-5
    B = torch.from_numpy(np.random.default_rng(5).standard_normal((300, 4)).astype(np.float32))
    assert rel_err(tsm.spmm(tw, B), m @ B.numpy()) < 1e-5          # through CSR
    assert rg.LAUNCHES == plan_launches({"well_spmv": 0, "well_spmm": 0})


# -- the CUDA kernel's design, replayed on the host ---------------------------------

def shuffled_with_stray(tw):
    """The tiles of ``tw`` in a random order, plus one tile aimed past the
    last row block."""
    perm = np.random.default_rng(7).permutation(tw.n_tiles)
    stray = dict(vals=torch.ones(1, ROW_BLOCK, tw.k_tile, dtype=tw.vals.dtype),
                 lidx=torch.zeros(1, ROW_BLOCK, tw.k_tile, dtype=torch.int32),
                 tile_rows=torch.tensor([tw.n_row_blocks + 3], dtype=torch.int32),
                 tile_wins=torch.zeros(1, dtype=torch.int32),
                 row_cnt=torch.full((1, ROW_BLOCK), tw.k_tile, dtype=torch.int32))
    return dataclasses.replace(
        tw, **{f: torch.cat([getattr(tw, f)[torch.from_numpy(perm)], stray[f]])
               for f in WELL_ARRAYS})


@pytest.mark.parametrize("seg_cols", [2048, 1])
@pytest.mark.parametrize("name", ["random_5pct", "dense_row", "empty_rows", "nnz0"])
def test_cuda_design_replay_in_and_out_of_block_order(name, seg_cols):
    """The row-group SpMV's walk (``csrc/spmv.cu`` in plain torch) over the
    WELL's plan; seg_cols = 1 cuts every group into one-column segments,
    so each group of several columns takes the partials path.  A WELL
    whose tiles arrive shuffled, with a tile past the last row block, has
    the same plan."""
    m = MATRICES[name]
    tw = tsm.CSR.from_scipy(m.astype(np.float64)).to_well(k_tile=4)
    x = np.random.default_rng(6).standard_normal(m.shape[1])
    want = m.astype(np.float64) @ x
    plan = rg.plan_of(tw)
    split = rg.SpmvSplit(plan, seg_cols=seg_cols)
    assert rel_err(rg.spmv_walk(plan, torch.from_numpy(x), split), want) < 1e-12
    shuffled = shuffled_with_stray(tw)
    other = rg.plan_of(shuffled)
    for f in ("grp_ptr", "cols", "mask", "vals"):
        assert torch.equal(getattr(other, f), getattr(plan, f)), f
    got = rg.spmv_walk(other, torch.from_numpy(x), rg.SpmvSplit(other, seg_cols=seg_cols))
    assert rel_err(got, want) < 1e-12
    assert rel_err(kw.well_spmv_ref(shuffled, torch.from_numpy(x)), want) < 1e-12


def test_segments_cover_every_block_once():
    """Rows that share no column, so groups of one row: row 0 holds 5
    entries (cut into segments of 2), rows 1 and 4 none (one empty segment
    each)."""
    rows = torch.tensor([0, 0, 0, 0, 0, 2, 3, 3, 5])
    cols = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8])
    plan = rg.build(rows, cols, torch.ones(9), (6, 20))
    assert plan.group == 1
    split = rg.SpmvSplit(plan, lanes=4, seg_cols=2)
    assert split.seg_ptr.tolist() == [0, 2, 4, 5, 5, 6, 8, 8, 9]
    assert split.seg_tag.tolist() == [-1, -1, -1, 1, 2, 3, 4, 5]
    assert split.multi.tolist() == [[0, 0, 3, 0]]          # group, first, count, slot
    assert (split.n_seg, split.n_multi, split.n_partial) == (8, 1, 3)
    np.testing.assert_array_equal(rg.spmv_walk(plan, torch.ones(20), split).numpy(),
                                  [5, 0, 1, 2, 0, 1])


# -- canonical views and structure ----------------------------------------------------

@pytest.mark.parametrize("name", ["stored_zero", "dense_row", "empty_rows", "nnz0"])
def test_to_csr_round_trip(name):
    m = MATRICES[name]
    m.sort_indices()
    tw = tsm.CSR.from_scipy(m).to_well(k_tile=4)
    back = tw.to_csr()
    got = sp.csr_matrix((back.data.numpy(), back.indices.numpy(), back.indptr.numpy()),
                        shape=back.shape)
    assert back.shape == m.shape
    assert back.n_non_zero_entries() == tw.n_non_zero_entries() == m.nnz  # stored zeros kept
    assert (got != m).nnz == 0
    np.testing.assert_array_equal(tw.todense().numpy(), m.toarray())


def test_to_coo_equals_reference():
    jw, tw = wells(MATRICES["stored_zero"], 4)
    jc, tc = jw.to_coo(), tw.to_coo()
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))


def test_scale_and_astype_keep_the_layout():
    m = MATRICES["random_5pct"]
    tw = tsm.CSR.from_scipy(m).to_well()
    x = np.random.default_rng(12).standard_normal(300)
    assert rel_err(tsm.spmv(2.0 * tw, torch.from_numpy(x).float()), 2 * (m @ x)) < 1e-5
    w64 = tw.scale(3.0).astype(torch.float64)
    assert w64.dtype == torch.float64 and torch.equal(w64.lidx, tw.lidx)
    assert torch.equal(w64.row_cnt, tw.row_cnt) and torch.equal(w64.tile_rows, tw.tile_rows)
    assert rel_err(tsm.spmv(w64, torch.from_numpy(x)), 3 * (m.astype(np.float64) @ x)) < 1e-6
    assert tw.spmv_traffic_bytes() == (tw.vals.numel() * 8 + tw.n_tiles * 8
                                       + 300 * 4 + 300 * 4)


# -- the CUDA kernel against its plain version (needs a card) -------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("k_tile", [None, 4])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_kernel_matches_plain(cuda, dtype, k_tile, name):
    tw = tsm.CSR.from_scipy(MATRICES[name], device=cuda).to_well(k_tile=k_tile).astype(dtype)
    x = torch.randn(tw.shape[1], device=cuda)
    x = x.to(dtype) if dtype != torch.bfloat16 else x
    rg.reset_launches()
    y = tsm.spmv(tw, x)
    y_ref = kw.well_spmv_ref(tw, x)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == plan_launches({"well_spmv": 1 if tw.shape[0] else 0,
                                         "well_spmm": 0})
    assert y.dtype == y_ref.dtype and y.shape == (tw.shape[0],)
    assert rel_err(y.cpu(), y_ref.cpu()) < TOL[dtype]
    assert torch.equal(tsm.spmv(tw, x), y)                   # reruns bitwise


@pytest.mark.cuda
def test_cuda_kernel_takes_tiles_out_of_block_order(cuda):
    """Shuffled tiles and a tile past the last row block: the same plan,
    the plain version's answer."""
    tw = tsm.CSR.from_scipy(MATRICES["random_5pct"], device="cpu").to_well(k_tile=4)
    shuffled = shuffled_with_stray(tw)
    tw, shuffled = (dataclasses.replace(w, **{f: getattr(w, f).to(cuda) for f in WELL_ARRAYS})
                    for w in (tw, shuffled))
    x = torch.randn(300, device=cuda)
    y = tsm.spmv(shuffled, x)
    assert rel_err(y.cpu(), kw.well_spmv_ref(tw, x).cpu()) < 1e-5
    assert rel_err(y.cpu(), kw.well_spmv_ref(shuffled, x).cpu()) < 1e-5
    assert torch.equal(tsm.spmv(tw, x), y)                 # one plan, one order
    assert all(torch.equal(tsm.spmv(shuffled, x), y) for _ in range(5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_sums_many_segments_of_a_block(cuda, dtype):
    """One union column a segment: every group of several takes the
    partials and the last-segment sum; the tickets reset, so reruns are
    bitwise equal."""
    tw = tsm.CSR.from_scipy(MATRICES["dense_row"], device=cuda).to_well(k_tile=4).astype(dtype)
    x = torch.randn(256, device=cuda, dtype=dtype)
    plan = rg.plan_of(tw)
    plan._spmv = rg.SpmvSplit(plan, seg_cols=1)
    assert plan.spmv.n_multi > 0
    y = tsm.spmv(tw, x)
    assert rel_err(y.cpu(), kw.well_spmv_ref(tw, x).cpu()) < TOL[dtype]
    assert rel_err(y.cpu(), rg.spmv_walk(plan, x).cpu()) < TOL[dtype]
    assert all(torch.equal(tsm.spmv(tw, x), y) for _ in range(5))   # reruns bitwise


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    tw = tsm.CSR.from_scipy(MATRICES["random_5pct"], device=cuda).to_well()
    with pytest.raises(ValueError):
        tsm.spmv(tw, torch.zeros(300))                          # x on the CPU
    with pytest.raises(ValueError):
        tsm.spmv(tw, torch.zeros(301, device=cuda))             # wrong length
    with pytest.raises(TypeError):
        tsm.spmv(tw, torch.zeros(300, dtype=torch.int32, device=cuda))
