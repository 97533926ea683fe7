"""The port's StripELL against the JAX package's on the same inputs: the
freeze gives the same arrays bit for bit (it is the same host numpy
program), the same errors, the same xᵀ tiles; ``strip_spmv_ref`` matches the
Pallas kernel in interpret mode and the XLA oracle; and (on a CUDA card) the
row-group SpMV over the matrix's plan matches the plain version and the
plan's walk.

Tolerances: relative to max|reference|, 1e-5 in f32 (other summation
orders), 1e-12 in f64.  f32 operands are passed explicitly, because
``tests/conftest.py`` turns on JAX's x64 mode.  The JAX package is imported
inside the tests, so the CUDA tests of this file also run on a machine
without JAX (``-m cuda --noconftest``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import plan_launches
from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch.formats import strip as tstrip
from sparsemat_tpu_torch.interop import from_reference
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.kernels import strip as ks

ARRAYS = ("vals", "lidx", "wrel", "wtile", "occ")


def banded_random(n, half_bw, density, seed=0, n_cols=None):
    """tests/test_strip.py's matrices: random entries within ``half_bw`` of
    the diagonal."""
    rng = np.random.default_rng(seed)
    n_cols = n if n_cols is None else n_cols
    m = sp.random(n, n_cols, density, format="coo", dtype=np.float32, random_state=rng)
    keep = np.abs(m.row - m.col) <= half_bw
    return sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])),
                         shape=(n, n_cols)).tocsr()


def with_stored_zero():
    m = banded_random(800, 300, 0.02, 5)
    m.data[[0, 17]] = 0.0          # stored entries whose value is zero
    return m


def rectangular(shape, density):
    return sp.random(*shape, density=density, format="csr", dtype=np.float32,
                     random_state=np.random.default_rng(4))


MATRICES = {
    "n3000": lambda: banded_random(3000, 1500, 0.004, 0),
    "n1000": lambda: banded_random(1000, 400, 0.02, 1),
    "n517": lambda: banded_random(517, 517, 0.05, 2),
    "n130": lambda: banded_random(130, 40, 0.3, 3),
    "stored_zero": with_stored_zero,
    "empty": lambda: sp.csr_matrix((300, 200), dtype=np.float32),
    "rect_5000x900": lambda: rectangular((5000, 900), 0.01),
    "rect_300x9000": lambda: rectangular((300, 9000), 0.02),
}
LAYOUTS = {"default": {}, "pack1": dict(lidx_pack=1),
           "pack2_group1": dict(lidx_pack=2, group=1), "group1": dict(group=1)}


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_ref():
    jsm = pytest.importorskip("sparsemat_tpu")
    from sparsemat_tpu.kernels import strip as jks

    return jsm, jks


def both(m, **kw):
    jsm, _ = jax_ref()
    return jsm.CSR.from_scipy(m).to_strip(**kw), tsm.CSR.from_scipy(m).to_strip(**kw)


def assert_parts_equal(jst, tst):
    assert len(jst.parts) == len(tst.parts)
    assert tst.shape == tuple(jst.shape)
    for jp, tp in zip(jst.parts, tst.parts):
        for f in ARRAYS:
            a = np.asarray(getattr(jp, f))
            b = getattr(tp, f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        assert (tp.block_ids, tp.g4, tp.lidx_pack) == (jp.block_ids, jp.g4, jp.lidx_pack)


# -- the freeze ------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", MATRICES)
def test_freeze_equals_reference(name, layout):
    m = MATRICES[name]()
    jst, tst = both(m, **LAYOUTS[layout])
    assert_parts_equal(jst, tst)
    assert tst.nse == jst.nse
    assert tst.n_non_zero_entries() == int(jst.n_non_zero_entries()) == m.nnz
    assert tst.spmv_traffic_bytes() == jst.spmv_traffic_bytes()
    assert tst.n_xt_tiles() == jst.n_xt_tiles()
    assert tst.fill_ratio() == pytest.approx(jst.fill_ratio(), rel=1e-12)


def test_freeze_of_f64_and_bf16_values():
    m = banded_random(1000, 400, 0.02, 1).astype(np.float64)
    jst, tst = both(m)
    assert_parts_equal(jst, tst)
    assert tst.dtype == torch.float64
    bf = tsm.CSR.from_scipy(m).astype(torch.bfloat16).to_strip()
    assert bf.dtype == torch.bfloat16
    for p, q in zip(bf.parts, tst.parts):
        np.testing.assert_array_equal(p.vals.float().numpy(),
                                      q.vals.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("kw,match", [
    (dict(), "span"),                 # wide scatter
    (dict(lidx_pack=3), "lidx_pack"),
])
def test_freeze_raises_as_reference(kw, match):
    jsm, _ = jax_ref()
    m = sp.random(400, 20000, 0.01, format="csr", dtype=np.float32,
                  random_state=np.random.default_rng(0))
    if "lidx_pack" in kw:
        m = banded_random(300, 50, 0.05, 1)
    with pytest.raises(ValueError, match=match):
        jsm.CSR.from_scipy(m).to_strip(**kw)
    with pytest.raises(ValueError, match=match):
        tsm.CSR.from_scipy(m).to_strip(**kw)


def test_freeze_raises_on_more_than_64_entries_in_one_row_window():
    jsm, _ = jax_ref()
    m = sp.csr_matrix((np.ones(100, np.float32), (np.zeros(100, int), np.arange(100))),
                      shape=(4, 128))
    with pytest.raises(ValueError, match=">64"):
        jsm.CSR.from_scipy(m).to_strip()
    with pytest.raises(ValueError, match=">64"):
        tsm.CSR.from_scipy(m).to_strip()


def test_build_xt_tiles_equals_reference():
    import jax.numpy as jnp
    from sparsemat_tpu.formats.strip import build_xt_tiles

    jax_ref()
    for n_cols in (30000, 500, 128):
        x = np.random.default_rng(n_cols).standard_normal(n_cols).astype(np.float32)
        want = np.asarray(build_xt_tiles(jnp.asarray(x), n_cols))
        got = tstrip.build_xt_tiles(torch.from_numpy(x), n_cols).numpy()
        np.testing.assert_array_equal(got, want)


# -- the SpMV ----------------------------------------------------------------------

@pytest.mark.parametrize("name,layout", [("n3000", "default"), ("n517", "pack1"),
                                         ("rect_300x9000", "pack2_group1"),
                                         ("empty", "default")])
def test_strip_spmv_ref_matches_pallas_interpret(name, layout):
    import jax.numpy as jnp

    _, jks = jax_ref()
    m = MATRICES[name]()
    jst, tst = both(m, **LAYOUTS[layout])
    x = np.random.default_rng(3).standard_normal(m.shape[1]).astype(np.float32)
    want = jks.strip_spmv_pallas(jst, jnp.asarray(x), interpret=True)
    got = ks.strip_spmv_ref(tst, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (m.shape[0],)
    assert rel_err(got, want) < 1e-5
    assert rel_err(got, m @ x) < 1e-5


@pytest.mark.parametrize("name", ["n1000", "stored_zero", "rect_5000x900", "n130"])
def test_strip_spmv_ref_matches_xla_oracle(name):
    import jax.numpy as jnp

    _, jks = jax_ref()
    m = MATRICES[name]()
    jst, tst = both(m)
    x = np.random.default_rng(5).standard_normal(m.shape[1]).astype(np.float32)
    assert rel_err(ks.strip_spmv_ref(tst, torch.from_numpy(x)),
                   jks.strip_spmv_xla(jst, jnp.asarray(x))) < 1e-5
    m64 = m.astype(np.float64)
    jst, tst = both(m64)
    x64 = x.astype(np.float64)
    got = ks.strip_spmv_ref(tst, torch.from_numpy(x64))
    assert got.dtype == torch.float64
    assert rel_err(got, jks.strip_spmv_xla(jst, jnp.asarray(x64))) < 1e-12


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_strip_spmv_low_precision_matches_xla_oracle(dtype):
    import jax.numpy as jnp

    jsm, jks = jax_ref()
    m = banded_random(1000, 400, 0.02, 1)
    tst = tsm.CSR.from_scipy(m).astype(dtype).to_strip()
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jst = jsm.CSR.from_scipy(m).astype(jdt).to_strip()
    x = np.random.default_rng(6).standard_normal(1000).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    want = jks.strip_spmv_xla(jst, jnp.asarray(x).astype(jdt))
    got = tsm.spmv(tst, xt)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert rel_err(got, want) < 1e-5


def test_spmv_dispatch_and_method():
    m = banded_random(1000, 400, 0.02, 1)
    csr = tsm.CSR.from_scipy(m)
    st = csr.to_strip()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(1000).astype(np.float32))
    y = tsm.spmv(st, x)
    assert torch.equal(y, ks.strip_spmv_ref(st, x))
    assert torch.equal(tsm.spmv(csr, x, method="strip"), y)
    assert torch.equal(st @ x, y)
    yd, d = tsm.spmv_dot(st, x)
    assert torch.equal(yd, y) and float(d) == pytest.approx(float(x @ y), rel=1e-6)
    y3 = tsm.spmv_chain(st, x, 3)
    assert rel_err(y3, m @ (m @ (m @ x.numpy()))) < 1e-5
    # the SlabStream method, ported since, computes
    assert rel_err(tsm.spmv(csr, x, method="slab_stream"), m @ x.numpy()) < 1e-5
    with pytest.raises(ValueError, match="unknown method"):
        tsm.spmv(csr, x, method="nope")


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    st = tsm.CSR.from_scipy(banded_random(300, 50, 0.05, 1)).to_strip()
    x = torch.randn(300)
    rg.reset_launches()
    assert torch.equal(tsm.spmv(st, x), ks.strip_spmv_ref(st, x))
    assert rg.LAUNCHES == plan_launches({"strip_spmv": 0, "strip_spmm": 0})


# -- canonical views, structure, interop -------------------------------------------

@pytest.mark.parametrize("name", ["stored_zero", "rect_300x9000", "empty"])
def test_to_csr_round_trip(name):
    m = MATRICES[name]()
    m.sort_indices()
    st = tsm.CSR.from_scipy(m).to_strip()
    back = st.to_csr()
    got = sp.csr_matrix((back.data.numpy(), back.indices.numpy(), back.indptr.numpy()),
                        shape=back.shape)
    assert back.shape == m.shape
    assert back.n_non_zero_entries() == st.n_non_zero_entries() == m.nnz
    assert (got != m).nnz == 0
    np.testing.assert_array_equal(st.todense().numpy(), m.toarray())


def test_scale_and_astype_keep_the_layout():
    m = banded_random(1000, 400, 0.02, 1)
    st = tsm.CSR.from_scipy(m).to_strip()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(1000))
    s2 = 2.0 * st
    assert rel_err(tsm.spmv(s2, x.float()), 2 * (m @ x.numpy())) < 1e-5
    s64 = st.astype(torch.float64)
    assert s64.dtype == torch.float64
    for p, q in zip(s64.parts, st.parts):
        assert torch.equal(p.lidx, q.lidx) and torch.equal(p.occ, q.occ)
        assert p.block_ids == q.block_ids
    assert tsm.spmv(s64, x).dtype == torch.float64


def test_from_reference_strip():
    import jax.numpy as jnp

    _, jks = jax_ref()
    m = banded_random(3000, 1500, 0.004, 0)
    jst, _ = both(m, lidx_pack=2)
    fields = {"parts": [dict({f: np.asarray(getattr(p, f)) for f in ARRAYS},
                             block_ids=p.block_ids, g4=p.g4, lidx_pack=p.lidx_pack)
                        for p in jst.parts]}
    tst = from_reference(fields, format="strip", shape=jst.shape)
    assert_parts_equal(jst, tst)
    x = np.random.default_rng(9).standard_normal(3000).astype(np.float32)
    assert rel_err(tsm.spmv(tst, torch.from_numpy(x)),
                   jks.strip_spmv_xla(jst, jnp.asarray(x))) < 1e-5
    with pytest.raises(ValueError, match="missing"):
        from_reference({"parts": [{"vals": np.zeros((1, 8, 128))}]}, format="strip",
                       shape=(10, 10))


# -- the CUDA kernel against its plain version (needs a card) ------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("name,layout", [(n, "default") for n in MATRICES]
                         + [("n3000", lay) for lay in LAYOUTS if lay != "default"])
def test_cuda_kernel_matches_plain(cuda, dtype, name, layout):
    m = MATRICES[name]()
    st = tsm.CSR.from_scipy(m, device=cuda).to_strip(**LAYOUTS[layout]).astype(dtype)
    x = torch.randn(m.shape[1], device=cuda)
    x = x.to(dtype) if dtype != torch.bfloat16 else x
    rg.reset_launches()
    y = tsm.spmv(st, x)
    y_ref = ks.strip_spmv_ref(st, x)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == plan_launches({"strip_spmv": 1, "strip_spmm": 0})
    assert y.dtype == y_ref.dtype and y.shape == (m.shape[0],)
    assert rel_err(y.cpu(), y_ref.cpu()) < TOL[dtype]
    assert rel_err(y.cpu(), rg.spmv_walk(rg.plan_of(st), x).cpu()) < TOL[dtype]
    assert torch.equal(tsm.spmv(st, x), y)          # reruns bitwise


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    st = tsm.CSR.from_scipy(banded_random(300, 50, 0.05, 1), device=cuda).to_strip()
    with pytest.raises(ValueError):
        tsm.spmv(st, torch.zeros(300))                  # vector on the CPU
    with pytest.raises(ValueError):
        tsm.spmv(st, torch.zeros(301, device=cuda))     # wrong length
    with pytest.raises(TypeError):
        tsm.spmv(st, torch.zeros(300, dtype=torch.int32, device=cuda))
