"""The port's SlabELL and SlabPack against the JAX package's on the same
inputs: the freezes give the same arrays and static fields bit for bit (the
overflow pack and nnz = 0 included); the four plain versions match the
Pallas kernels in interpret mode and the XLA oracles; ``scale``/``astype``
keep the layout; round trips keep stored zeros; and (on a CUDA card) the
CUDA kernels match the plain versions (the SpMM, the row-group kernel,
also on a long power-law row and where B holds inf or NaN).

Tolerances: relative to max|reference|, 1e-5 in f32 (another summation
order), 1e-12 in f64.  f32 operands are passed explicitly, because
``tests/conftest.py`` turns on JAX's x64 mode.  The JAX package is imported
inside the tests, so the CUDA tests of this file also run on a machine
without JAX (``-m cuda --noconftest``).  The interpret-mode cases are few
and small: each costs seconds of Pallas tracing.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import plan_launches
from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.kernels import slab as ksl

SLAB_ARRAYS = ("vals", "lidx", "win_lo", "bucket_cnt")


def scattered_band(n, k, band, seed=0):
    """tests/test_slab.py's matrices: k entries per row within ``band`` of
    the diagonal."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-band, band + 1, size=n * k), 0, n - 1)
    vals = rng.standard_normal(n * k).astype(np.float32)
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    return m


def mixed_degree(n=2000, seed=0):
    """Interleaved light and heavy rows, as in tests/test_gell_pack.py: the
    spill path engages, so the pack has an overflow."""
    rng = np.random.default_rng(seed)
    deg = np.where(np.arange(n) % 7, 3, 60)
    rows = np.repeat(np.arange(n), deg)
    cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def fem_like(n=600, seed=0):
    """tests/test_spmm_blocked.py's matrices: random entries plus a diagonal."""
    m = sp.random(n, n, 0.02, random_state=seed, format="csr").astype(np.float32)
    m = (m + sp.eye(n, dtype=np.float32, format="csr")).tocsr()
    m.sort_indices()
    return m


def empty_rows_tail():
    """tests/test_slab.py's 77 rows, two of every three empty."""
    rng = np.random.default_rng(5)
    dense = np.zeros((77, 77), np.float32)
    for i in range(0, 77, 3):
        dense[i, rng.integers(0, 77, 4)] = rng.standard_normal(4)
    return sp.csr_matrix(dense)


def with_stored_zero():
    m = scattered_band(300, 9, 50, seed=8)
    m.data[[0, 11]] = 0.0           # stored entries whose value is zero
    return m


MATRICES = {
    "band_400": lambda: scattered_band(400, 9, 50, seed=3),
    "band_260_k140": lambda: scattered_band(260, 140, 20, seed=3),
    "band_300_wide": lambda: scattered_band(300, 5, 200, seed=3),
    "mixed_1500": lambda: mixed_degree(1500, 4),
    "fem_700": lambda: fem_like(700, 3),
    "empty_rows_tail": empty_rows_tail,
    "stored_zero": with_stored_zero,
    "rect_300x900": lambda: sp.random(300, 900, 0.02, format="csr", dtype=np.float32,
                                      random_state=np.random.default_rng(4)),
    "empty": lambda: sp.csr_matrix((300, 200), dtype=np.float32),
}
#: SlabPack layouts: (rb, n_classes, spill_frac)
PACKS = {"default": (256, 8, 0.02), "rb128_c3": (128, 3, 0.02), "no_spill": (256, 6, 0.0)}


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_ref():
    jsm = pytest.importorskip("sparsemat_tpu")
    from sparsemat_tpu.kernels import spmm as jkm
    from sparsemat_tpu.kernels import spmv as jkv

    return jsm, jkv, jkm


def slabs(m, rb=256):
    jsm, _, _ = jax_ref()
    return (jsm.SlabELL.from_csr(jsm.CSR.from_scipy(m), rb=rb),
            tsm.SlabELL.from_csr(tsm.CSR.from_scipy(m), rb=rb))


def packs(m, layout="default"):
    jsm, _, _ = jax_ref()
    rb, nc, spill = PACKS[layout]
    return (jsm.SlabPack.from_csr(jsm.CSR.from_scipy(m), rb=rb, n_classes=nc, spill_frac=spill),
            tsm.SlabPack.from_csr(tsm.CSR.from_scipy(m), rb=rb, n_classes=nc,
                                  spill_frac=spill))


def assert_slab_equal(js, ts):
    assert ts.shape == tuple(js.shape) and ts.buckets == js.buckets
    for f in SLAB_ARRAYS:
        a, b = getattr(js, f), getattr(ts, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def assert_pack_equal(jp, tp):
    assert tp.shape == tuple(jp.shape) and tp.row_block == jp.row_block
    assert tp.block_ids == jp.block_ids and len(tp.parts) == len(jp.parts)
    for a, b in zip(jp.parts, tp.parts):
        assert_slab_equal(a, b)
    assert (tp.overflow is None) == (jp.overflow is None)
    if jp.overflow is not None:
        assert_pack_equal(jp.overflow, tp.overflow)


# -- the freeze ------------------------------------------------------------------

@pytest.mark.parametrize("rb", [128, 256])
@pytest.mark.parametrize("name", MATRICES)
def test_slab_freeze_equals_reference(name, rb):
    m = MATRICES[name]()
    js, ts = slabs(m, rb)
    assert_slab_equal(js, ts)
    assert (ts.nse, ts.row_block, ts.n_row_blocks, ts.c_total, ts.slab_windows) == \
        (js.nse, js.row_block, js.n_row_blocks, js.c_total, js.slab_windows)
    assert (ts.x_windows(), ts.x_bytes(), ts.x_bytes(8)) == \
        (js.x_windows(), js.x_bytes(), js.x_bytes(8))
    assert ts.n_non_zero_entries() == int(js.n_non_zero_entries()) == m.nnz
    assert ts.fill_ratio() == pytest.approx(js.fill_ratio(), rel=1e-12)
    np.testing.assert_array_equal(ts._window_of_cpos(), js._window_of_cpos())


@pytest.mark.parametrize("layout", PACKS)
@pytest.mark.parametrize("name", MATRICES)
def test_slab_pack_freeze_equals_reference(name, layout):
    m = MATRICES[name]()
    jp, tp = packs(m, layout)
    assert_pack_equal(jp, tp)
    assert (tp.nse, tp.n_row_blocks, tp.spmv_traffic_bytes(), tp.max_part_tile_bytes(),
            tp.x_bytes()) == (jp.nse, jp.n_row_blocks, jp.spmv_traffic_bytes(),
                              jp.max_part_tile_bytes(), jp.x_bytes())
    assert tp.n_non_zero_entries() == int(jp.n_non_zero_entries()) == m.nnz
    assert tp.fill_ratio() == pytest.approx(jp.fill_ratio(), rel=1e-12)


def test_mixed_degree_pack_spills_into_an_overflow():
    jp, tp = packs(mixed_degree(2000, 0))
    assert tp.overflow is not None and tp.overflow.row_block == 128
    assert tp.overflow.overflow is None                   # refrozen without spilling
    assert_pack_equal(jp, tp)
    assert tp.nse < tsm.CSR.from_scipy(mixed_degree(2000, 0)).to_slab().nse


def test_freeze_of_f64_and_bf16_values():
    m = mixed_degree(1500, 4).astype(np.float64)
    js, ts = slabs(m)
    assert_slab_equal(js, ts)
    jp, tp = packs(m)
    assert_pack_equal(jp, tp)
    assert tp.dtype == torch.float64
    bf = tsm.CSR.from_scipy(m).astype(torch.bfloat16).to_slab_pack()
    assert bf.dtype == torch.bfloat16 and bf.block_ids == tp.block_ids
    np.testing.assert_array_equal(bf.parts[0].vals.float().numpy(),
                                  tp.parts[0].vals.to(torch.bfloat16).float().numpy())


def test_rb_must_be_a_multiple_of_128():
    jsm, _, _ = jax_ref()
    m = scattered_band(200, 7, 30)
    for pkg in (jsm, tsm):
        for cls in (pkg.SlabELL, pkg.SlabPack):
            with pytest.raises(ValueError, match="multiple of 128"):
                cls.from_csr(pkg.CSR.from_scipy(m), rb=32)


# -- the plain versions against the JAX package's kernels and oracles ---------------

@pytest.mark.parametrize("name,rb", [("band_260_k140", 256), ("empty_rows_tail", 128)])
def test_slab_spmv_ref_matches_pallas_interpret(name, rb):
    import jax.numpy as jnp

    _, jkv, _ = jax_ref()
    m = MATRICES[name]()
    js, ts = slabs(m, rb)
    x = np.random.default_rng(4).standard_normal(m.shape[1]).astype(np.float32)
    got = ksl.slab_spmv_ref(ts, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (m.shape[0],)
    assert rel_err(got, jkv.slab_spmv_pallas(js, jnp.asarray(x), interpret=True)) < 1e-5
    assert rel_err(got, m @ x) < 1e-5


def test_slab_pack_spmv_ref_matches_pallas_interpret():
    import jax.numpy as jnp

    _, jkv, _ = jax_ref()
    m = mixed_degree(400, 0)
    jp, tp = packs(m, "rb128_c3")
    assert tp.overflow is not None
    x = np.random.default_rng(3).standard_normal(400).astype(np.float32)
    got = ksl.slab_pack_spmv_ref(tp, torch.from_numpy(x))
    assert rel_err(got, jkv.slab_pack_spmv_pallas(jp, jnp.asarray(x), interpret=True)) < 1e-5
    assert rel_err(got, m @ x) < 1e-5


@pytest.mark.parametrize("m_rhs,mc", [(5, 4), (1, 1)])
def test_slab_spmm_ref_matches_pallas_interpret(m_rhs, mc):
    import jax.numpy as jnp

    _, _, jkm = jax_ref()
    m = fem_like(300, 5)
    js, ts = slabs(m, 128)
    B = np.random.default_rng(1).standard_normal((300, m_rhs)).astype(np.float32)
    got = ksl.slab_spmm_ref(ts, torch.from_numpy(B))
    assert got.shape == (300, m_rhs)
    assert rel_err(got, jkm.slab_spmm_pallas(js, jnp.asarray(B), mc=mc, interpret=True)) < 1e-5
    assert rel_err(got, m @ B) < 1e-5


def test_slab_pack_spmm_ref_matches_pallas_interpret():
    """The JAX package has no XLA oracle for the SlabPack SpMM: the Pallas
    composition in interpret mode is the reference."""
    import jax.numpy as jnp

    _, _, jkm = jax_ref()
    m = mixed_degree(400, 0)
    jp, tp = packs(m, "rb128_c3")
    B = np.random.default_rng(2).standard_normal((400, 3)).astype(np.float32)
    got = ksl.slab_pack_spmm_ref(tp, torch.from_numpy(B))
    assert rel_err(got, jkm.slab_pack_spmm_pallas(jp, jnp.asarray(B), interpret=True)) < 1e-5
    assert rel_err(got, m @ B) < 1e-5


@pytest.mark.parametrize("name", ["band_400", "band_300_wide", "stored_zero", "rect_300x900",
                                  "empty"])
def test_slab_spmv_and_spmm_ref_match_xla_oracles(name):
    import jax.numpy as jnp

    _, jkv, jkm = jax_ref()
    m = MATRICES[name]()
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        js, ts = slabs(m.astype(dt))
        x = np.random.default_rng(5).standard_normal(m.shape[1]).astype(dt)
        got = ksl.slab_spmv_ref(ts, torch.from_numpy(x))
        assert got.dtype == torch.from_numpy(x).dtype
        assert rel_err(got, jkv.slab_spmv_xla(js, jnp.asarray(x))) < tol
        B = np.random.default_rng(6).standard_normal((m.shape[1], 7)).astype(dt)
        assert rel_err(ksl.slab_spmm_ref(ts, torch.from_numpy(B)),
                       jkm.slab_spmm_xla(js, jnp.asarray(B))) < tol


@pytest.mark.parametrize("name,layout", [("mixed_1500", "default"), ("fem_700", "rb128_c3"),
                                         ("stored_zero", "no_spill"), ("empty", "default")])
def test_slab_pack_spmv_ref_matches_xla_oracle(name, layout):
    import jax.numpy as jnp

    _, jkv, _ = jax_ref()
    m = MATRICES[name]()
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        jp, tp = packs(m.astype(dt), layout)
        x = np.random.default_rng(7).standard_normal(m.shape[1]).astype(dt)
        got = ksl.slab_pack_spmv_ref(tp, torch.from_numpy(x))
        assert rel_err(got, jkv.slab_pack_spmv_xla(jp, jnp.asarray(x))) < tol
        B = np.random.default_rng(8).standard_normal((m.shape[1], 4)).astype(dt)
        assert rel_err(ksl.slab_pack_spmm_ref(tp, torch.from_numpy(B)),
                       (m.astype(np.float64) @ B.astype(np.float64))) < tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_matches_xla_oracles(dtype):
    import jax.numpy as jnp

    jsm, jkv, jkm = jax_ref()
    m = mixed_degree(1500, 4)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jc, tc = jsm.CSR.from_scipy(m).astype(jdt), tsm.CSR.from_scipy(m).astype(dtype)
    x = np.random.default_rng(9).standard_normal(1500).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(dtype)
    got = tsm.spmv(tc.to_slab_pack(), tx)
    assert got.dtype == torch.float32
    assert rel_err(got, jkv.slab_pack_spmv_xla(jc.to_slab_pack(), jx)) < 1e-5
    assert rel_err(tsm.spmv(tc.to_slab(), tx), jkv.slab_spmv_xla(jc.to_slab(), jx)) < 1e-5
    B = np.random.default_rng(10).standard_normal((1500, 3)).astype(np.float32)
    assert rel_err(tsm.spmm(tc.to_slab(), torch.from_numpy(B).to(dtype)),
                   jkm.slab_spmm_xla(jc.to_slab(), jnp.asarray(B).astype(jdt))) < 1e-5


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    m = mixed_degree(400, 0)
    sl = tsm.CSR.from_scipy(m).to_slab()
    pk = tsm.CSR.from_scipy(m).to_slab_pack(rb=128, n_classes=3)
    x, B = torch.randn(400), torch.randn(400, 6)
    rg.reset_launches()
    assert torch.equal(tsm.spmv(sl, x), ksl.slab_spmv_ref(sl, x))
    assert torch.equal(tsm.spmv(pk, x), ksl.slab_pack_spmv_ref(pk, x))
    assert torch.equal(tsm.spmm(sl, B), ksl.slab_spmm_ref(sl, B))
    assert torch.equal(tsm.spmm(pk, B), ksl.slab_pack_spmm_ref(pk, B))
    assert rg.LAUNCHES == plan_launches({"slab_spmv": 0, "slab_spmm": 0,
                                         "slab_stream_spmv": 0, "slab_stream_spmm": 0})


def test_plain_spmm_groups_columns_within_its_budget(monkeypatch):
    m = fem_like(700, 3)
    sl = tsm.CSR.from_scipy(m).to_slab(rb=128)
    B = torch.from_numpy(np.random.default_rng(11).standard_normal((700, 13)))
    whole = ksl.slab_spmm_ref(sl, B)
    monkeypatch.setattr(ksl, "_REF_GATHER_BUDGET", sl.nse * 8 * 3)    # 3 columns a group
    assert torch.allclose(ksl.slab_spmm_ref(sl, B), whole, rtol=0, atol=1e-12)
    assert rel_err(whole, m @ B.numpy()) < 1e-12


# -- canonical views and structure ----------------------------------------------------

@pytest.mark.parametrize("fmt", ["slab", "slab_pack"])
@pytest.mark.parametrize("name", ["stored_zero", "mixed_1500", "empty_rows_tail", "empty"])
def test_to_csr_round_trip(name, fmt):
    m = MATRICES[name]()
    m.sort_indices()
    mat = getattr(tsm.CSR.from_scipy(m), f"to_{fmt}")()
    back = mat.to_csr()
    got = sp.csr_matrix((back.data.numpy(), back.indices.numpy(), back.indptr.numpy()),
                        shape=back.shape)
    assert back.shape == m.shape
    assert back.n_non_zero_entries() == mat.n_non_zero_entries() == m.nnz  # stored zeros kept
    assert (got != m).nnz == 0
    np.testing.assert_array_equal(mat.todense().numpy(), m.toarray())


def test_to_coo_equals_reference():
    jsm, _, _ = jax_ref()
    m = with_stored_zero()
    jp, tp = packs(m, "rb128_c3")
    for j, t in ((jp, tp), (jp.parts[0], tp.parts[0])):
        jc, tc = j.to_coo(), t.to_coo()
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))


def test_scale_and_astype_keep_the_layout():
    m = mixed_degree(1500, 4)
    tp = tsm.CSR.from_scipy(m).to_slab_pack()
    x = np.random.default_rng(12).standard_normal(1500)
    assert rel_err(tsm.spmv(2.0 * tp, torch.from_numpy(x).float()), 2 * (m @ x)) < 1e-5
    assert rel_err(tsm.spmv(tp.parts[0].scale(3.0).astype(torch.float64),
                            torch.from_numpy(x)),
                   3 * ksl.slab_spmv_ref(tp.parts[0], torch.from_numpy(x).float())) < 1e-6
    p64 = tp.astype(torch.float64)
    assert p64.dtype == torch.float64 and p64.overflow.dtype == torch.float64
    assert p64.block_ids == tp.block_ids
    for a, b in zip(p64.parts, tp.parts):
        assert torch.equal(a.lidx, b.lidx) and torch.equal(a.bucket_cnt, b.bucket_cnt)
    assert rel_err(tsm.spmv(p64, torch.from_numpy(x)), m.astype(np.float64) @ x) < 1e-12


# -- the CUDA kernels against their plain versions (need a card) -----------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-5}
CUDA_CASES = [("slab", "band_260_k140", 128), ("slab", "empty_rows_tail", 256),
              ("slab", "rect_300x900", 256), ("slab", "stored_zero", 128),
              ("slab", "empty", 256), ("slab_pack", "mixed_1500", "default"),
              ("slab_pack", "mixed_1500", "no_spill"), ("slab_pack", "fem_700", "rb128_c3"),
              ("slab_pack", "empty", "default")]


def on_card(kind, name, arg, device):
    csr = tsm.CSR.from_scipy(MATRICES[name](), device=device)
    if kind == "slab":
        return csr.to_slab(rb=arg)
    rb, nc, spill = PACKS[arg]
    return tsm.SlabPack.from_csr(csr, rb=rb, n_classes=nc, spill_frac=spill)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("kind,name,arg", CUDA_CASES)
def test_cuda_kernels_match_plain(cuda, dtype, kind, name, arg):
    mat = on_card(kind, name, arg, cuda).astype(dtype)
    spmv_ref, spmm_ref = ((ksl.slab_spmv_ref, ksl.slab_spmm_ref) if kind == "slab"
                          else (ksl.slab_pack_spmv_ref, ksl.slab_pack_spmm_ref))
    x = torch.randn(mat.shape[1], device=cuda)
    x = x.to(dtype) if dtype != torch.bfloat16 else x
    rg.reset_launches()
    y = tsm.spmv(mat, x)
    y_ref = spmv_ref(mat, x)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == plan_launches({"slab_spmv": 1, "slab_spmm": 0,  # one launch a product,
                                         "slab_stream_spmv": 0,
                                         "slab_stream_spmm": 0})       # any level count
    assert y.dtype == y_ref.dtype and y.shape == (mat.shape[0],)
    assert rel_err(y.cpu(), y_ref.cpu()) < TOL[dtype]
    assert torch.equal(tsm.spmv(mat, x), y)                   # reruns bitwise
    for m_rhs in (1, 5, 17, 128, 129):
        B = torch.randn(mat.shape[1], m_rhs, device=cuda)
        B = B.to(dtype) if dtype != torch.bfloat16 else B
        Y = tsm.spmm(mat, B)
        Y_ref = spmm_ref(mat, B)
        torch.cuda.synchronize()
        assert Y.dtype == Y_ref.dtype and Y.shape == (mat.shape[0], m_rhs)
        assert rel_err(Y.cpu(), Y_ref.cpu()) < TOL[dtype], m_rhs
        assert torch.equal(tsm.spmm(mat, B), Y)
    assert rg.LAUNCHES["slab_spmm"] == 10                # one launch a product, any level count


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slab", "slab_pack"])
def test_cuda_spmm_walks_a_long_power_law_row(cuda, kind):
    rng = np.random.default_rng(7)
    m = mixed_degree(3000, 7).tolil()
    m[1234, rng.choice(3000, 900, replace=False)] = rng.standard_normal(900)
    m = m.tocsr().astype(np.float32)
    csr = tsm.CSR.from_scipy(m, device=cuda)
    mat = csr.to_slab() if kind == "slab" else csr.to_slab_pack()
    spmm_ref = ksl.slab_spmm_ref if kind == "slab" else ksl.slab_pack_spmm_ref
    B = torch.randn(3000, 33, device=cuda)
    Y = tsm.spmm(mat, B)
    assert rel_err(Y.cpu(), spmm_ref(mat, B).cpu()) < 1e-5
    assert rel_err(Y.cpu(), m.astype(np.float64) @ B.double().cpu().numpy()) < 1e-5
    assert torch.equal(tsm.spmm(mat, B), Y)


@pytest.mark.cuda
def test_cuda_spmm_gives_a_csr_spmm_answer_on_non_finite_b(cuda):
    """A padding slot reads no B (a CSR SpMM's answer where B holds inf
    there), a stored zero gives 0 · inf = NaN."""
    m = with_stored_zero().tocoo()
    free = 128                                         # no entry reads it
    keep = m.col != free
    m = sp.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    z = int(np.flatnonzero(m.data == 0)[0])            # a stored zero
    r0 = int(np.searchsorted(m.indptr, z, side="right") - 1)
    B = np.ones((300, 2), np.float32)
    B[int(m.indices[z]), 0] = np.inf
    B[free, 1] = np.nan
    pk = tsm.CSR.from_scipy(m, device=cuda).to_slab_pack()
    sl = tsm.CSR.from_scipy(m, device=cuda).to_slab(rb=128)
    pad_cols = ksl._slab_cols(sl)[~sl._stored_mask()]
    assert bool((pad_cols == free).any())              # padding slots point at it
    want = m @ B
    assert np.isnan(want[r0, 0]) and not np.isnan(want[:, 1]).any()
    Bt = torch.from_numpy(B).to(cuda)
    for mat in (sl, pk):
        np.testing.assert_allclose(tsm.spmm(mat, Bt).cpu().numpy(), want, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
    assert torch.isnan(ksl.slab_spmm_ref(sl, Bt)[:, 1]).any()


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    pk = on_card("slab_pack", "mixed_1500", "default", cuda)
    with pytest.raises(ValueError):
        tsm.spmv(pk, torch.zeros(1500))                       # x on the CPU
    with pytest.raises(ValueError):
        tsm.spmv(pk, torch.zeros(1501, device=cuda))          # wrong length
    with pytest.raises(TypeError):
        tsm.spmm(pk, torch.zeros(1500, 3, dtype=torch.int32, device=cuda))
