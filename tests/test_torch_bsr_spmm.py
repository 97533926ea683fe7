"""The port's BSR and its SpMM against the JAX package's on the same inputs:
the host and device freezes give the same arrays bit for bit (empty block
rows and nnz = 0 included); ``bsr_spmm_ref`` matches the Pallas kernel in
interpret mode and the XLA oracle; round trips keep stored zeros; and (on a
CUDA card) the row-group kernel matches the plain version at every width,
on a long power-law row and on an unaligned B, reruns bitwise, and gives a
CSR SpMM's answer where B holds inf or NaN.

Tolerances: relative to max|reference|, 1e-5 in f32 (another summation
order), 1e-12 in f64.  f32 operands are passed explicitly, because
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
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.kernels import spmm as ksp

ARRAYS = ("blocks", "block_rows", "block_cols", "occ")


def blocky(n_rows, n_cols, density, seed, block=(8, 128)):
    """tests/test_bsr_spmm.py's block-structured matrices: whole (br × bc)
    blocks switched on at ``density``."""
    rng = np.random.default_rng(seed)
    br, bc = block
    rb, cb = -(-n_rows // br), -(-n_cols // bc)
    mask = rng.random((rb, cb)) < density
    dense = np.zeros((rb * br, cb * bc), np.float32)
    for i, j in zip(*np.nonzero(mask)):
        dense[i * br:(i + 1) * br, j * bc:(j + 1) * bc] = rng.standard_normal((br, bc))
    return sp.csr_matrix(dense[:n_rows, :n_cols])


def scattered(n_rows, n_cols, density, seed):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n_rows, n_cols)).astype(np.float32)
    dense[rng.random((n_rows, n_cols)) >= density] = 0
    return sp.csr_matrix(dense)


def empty_block_rows():
    """tests/test_bsr_spmm.py's device-freeze matrix: rows 40–119 empty."""
    rng = np.random.default_rng(11)
    dense = np.zeros((300, 520), np.float32)
    mask = rng.random(dense.shape) < 0.03
    dense[mask] = rng.standard_normal(int(mask.sum()))
    dense[40:120] = 0.0
    return sp.csr_matrix(dense)


def with_stored_zero():
    m = scattered(40, 200, 0.2, 3)
    m.data[[0, 5]] = 0.0            # stored entries whose value is zero
    return m


MATRICES = {
    "blocky_64x256": lambda: blocky(64, 256, 0.15, 4),
    "blocky_100x300": lambda: blocky(100, 300, 0.15, 4),
    "scattered_72x150": lambda: scattered(72, 150, 0.1, 2),
    "empty_block_rows": empty_block_rows,
    "stored_zero": with_stored_zero,
    "empty": lambda: sp.csr_matrix((64, 64), dtype=np.float32),
}
BLOCKS = [(8, 128), (16, 256), (64, 128), (512, 128)]


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_ref():
    jsm = pytest.importorskip("sparsemat_tpu")
    from sparsemat_tpu.kernels import spmm as jks

    return jsm, jks


def both(m, device=False, **kw):
    jsm, _ = jax_ref()
    jc, tc = jsm.CSR.from_scipy(m), tsm.CSR.from_scipy(m)
    if device:
        return jsm.BSR.from_csr_device(jc, **kw), tsm.BSR.from_csr_device(tc, **kw)
    return jsm.BSR.from_csr(jc, **kw), tsm.BSR.from_csr(tc, **kw)


def assert_bsr_equal(jb, tb):
    assert tb.shape == tuple(jb.shape)
    for f in ARRAYS:
        a, b = getattr(jb, f), getattr(tb, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


# -- the freeze ------------------------------------------------------------------

@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("block", BLOCKS, ids=[f"{r}x{c}" for r, c in BLOCKS])
@pytest.mark.parametrize("name", MATRICES)
def test_freeze_equals_reference(name, block, device):
    m = MATRICES[name]()
    jb, tb = both(m, device, br=block[0], bc=block[1])
    assert_bsr_equal(jb, tb)
    assert (tb.nse, tb.n_tiles, tb.br, tb.bc) == (jb.nse, jb.n_tiles, jb.br, jb.bc)
    assert tb.n_non_zero_entries() == int(jb.n_non_zero_entries())
    assert tb.fill_ratio() == pytest.approx(jb.fill_ratio(), rel=1e-12)
    if device:       # the host arrays stay cached: the kernel's plan reads no device
        np.testing.assert_array_equal(tb.__dict__["_host_cache"]["block_rows"],
                                      np.asarray(jb.block_rows))


def test_freeze_of_f64_and_bf16_values():
    m = empty_block_rows().astype(np.float64)
    jb, tb = both(m)
    assert_bsr_equal(jb, tb)
    assert tb.dtype == torch.float64
    c16 = tsm.CSR.from_scipy(m).astype(torch.bfloat16)
    for freeze in (tsm.BSR.from_csr, tsm.BSR.from_csr_device):
        b = freeze(c16)
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.blocks.float().numpy(),
                                      tb.blocks.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("br,bc", [(7, 128), (8, 100), (0, 128)])
def test_misaligned_blocks_raise(br, bc):
    jsm, _ = jax_ref()
    m = scattered(16, 128, 0.4, 13)
    if br:        # the JAX package passes br = 0 to numpy's % and fails later
        with pytest.raises(ValueError):
            jsm.BSR.from_csr(jsm.CSR.from_scipy(m), br=br, bc=bc)
    for freeze in (tsm.BSR.from_csr, tsm.BSR.from_csr_device):
        with pytest.raises(ValueError, match="8k, 128k"):
            freeze(tsm.CSR.from_scipy(m), br=br, bc=bc)


# -- the SpMM ----------------------------------------------------------------------

@pytest.mark.parametrize("name,m_rhs,device", [("blocky_64x256", 64, False),
                                               ("blocky_100x300", 129, False),
                                               ("empty_block_rows", 17, True),
                                               ("empty", 8, True)])
def test_bsr_spmm_ref_matches_pallas_interpret(name, m_rhs, device):
    import jax.numpy as jnp

    _, jks = jax_ref()
    m = MATRICES[name]()
    jb, tb = both(m, device)
    B = np.random.default_rng(5).standard_normal((m.shape[1], m_rhs)).astype(np.float32)
    want = jks.bsr_spmm_pallas(jb, jnp.asarray(B), interpret=True)
    got = ksp.bsr_spmm_ref(tb, torch.from_numpy(B))
    assert got.dtype == torch.float32 and got.shape == (m.shape[0], m_rhs)
    assert rel_err(got, want) < 1e-5
    assert rel_err(got, m @ B) < 1e-5


@pytest.mark.parametrize("block", [(8, 128), (16, 256)])
@pytest.mark.parametrize("m_rhs", [1, 7, 64, 130])
def test_bsr_spmm_ref_matches_xla_oracle(m_rhs, block):
    import jax.numpy as jnp

    _, jks = jax_ref()
    m = MATRICES["scattered_72x150"]()
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        jb, tb = both(m.astype(dt), br=block[0], bc=block[1])
        B = np.random.default_rng(m_rhs).standard_normal((150, m_rhs)).astype(dt)
        got = ksp.bsr_spmm_ref(tb, torch.from_numpy(B))
        assert got.dtype == torch.from_numpy(B).dtype
        assert rel_err(got, jks.bsr_spmm_xla(jb, jnp.asarray(B))) < tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_bsr_spmm_low_precision_matches_xla_oracle(dtype):
    import jax.numpy as jnp

    jsm, jks = jax_ref()
    m = MATRICES["blocky_64x256"]()
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jb = jsm.BSR.from_csr(jsm.CSR.from_scipy(m)).astype(jdt)
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(m)).astype(dtype)
    B = np.random.default_rng(6).standard_normal((256, 9)).astype(np.float32)
    want = jks.bsr_spmm_xla(jb, jnp.asarray(B).astype(jdt))
    got = tsm.spmm(tb, torch.from_numpy(B).to(dtype))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert rel_err(got, want) < 1e-5


def test_zero_columns_and_no_tiles_give_zeros():
    m = MATRICES["blocky_64x256"]()
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(m))
    y = tsm.spmm(tb, torch.zeros((256, 0)))
    assert y.shape == (64, 0)
    none = tsm.BSR(blocks=torch.zeros((0, 8, 128)), block_rows=torch.zeros(0, dtype=torch.int32),
                   block_cols=torch.zeros(0, dtype=torch.int32), occ=None, shape=(64, 256))
    assert torch.equal(tsm.spmm(none, torch.ones((256, 3))), torch.zeros((64, 3)))


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(MATRICES["blocky_64x256"]()))
    B = torch.randn(256, 5)
    rg.reset_launches()
    assert torch.equal(tb @ B, ksp.bsr_spmm_ref(tb, B))
    assert torch.equal(tsm.spmm(tb, B), ksp.bsr_spmm_ref(tb, B))
    assert rg.LAUNCHES == plan_launches({"bsr_spmm": 0})
    with pytest.raises(ValueError):
        tsm.spmm(tb, torch.randn(255, 5))


# -- canonical views and structure -----------------------------------------------------

@pytest.mark.parametrize("name", ["stored_zero", "empty_block_rows", "empty"])
def test_to_csr_round_trip(name):
    m = MATRICES[name]()
    m.sort_indices()
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(m))
    back = tb.to_csr()
    got = sp.csr_matrix((back.data.numpy(), back.indices.numpy(), back.indptr.numpy()),
                        shape=back.shape)
    assert back.shape == m.shape
    assert back.n_non_zero_entries() == tb.n_non_zero_entries() == m.nnz   # stored zeros kept
    assert (got != m).nnz == 0
    np.testing.assert_array_equal(tb.todense().numpy(), m.toarray())
    dev = tsm.BSR.from_csr_device(tsm.CSR.from_scipy(m))     # no occ: zeros drop out
    assert dev.n_non_zero_entries() == int((m.data != 0).sum())
    np.testing.assert_array_equal(dev.todense().numpy(), m.toarray())


def test_scale_and_astype_keep_the_layout():
    m = MATRICES["blocky_100x300"]()
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(m))
    B = np.random.default_rng(8).standard_normal((300, 4))
    assert rel_err(tsm.spmm(2.0 * tb, torch.from_numpy(B).float()), 2 * (m @ B)) < 1e-5
    b64 = tb.astype(torch.float64)
    assert b64.dtype == torch.float64 and torch.equal(b64.occ, tb.occ)
    assert torch.equal(b64.block_rows, tb.block_rows) and torch.equal(b64.block_cols, tb.block_cols)
    assert rel_err(tsm.spmm(b64, torch.from_numpy(B)), m @ B) < 1e-12


# -- the CUDA kernel against its plain version (needs a card) ------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("m_rhs", [1, 5, 17, 128, 129])
@pytest.mark.parametrize("name,block", [
    ("blocky_64x256", (8, 128)), ("blocky_100x300", (8, 128)),
    ("empty_block_rows", (16, 256)), ("empty_block_rows", (512, 128)),
    ("scattered_72x150", (64, 128)), ("stored_zero", (8, 128)), ("empty", (8, 128))])
def test_cuda_kernel_matches_plain(cuda, dtype, name, block, m_rhs):
    m = MATRICES[name]()
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(m, device=cuda), br=block[0],
                          bc=block[1]).astype(dtype)
    B = torch.randn(m.shape[1], m_rhs, device=cuda)
    B = B.to(dtype) if dtype != torch.bfloat16 else B
    rg.reset_launches()
    y = tsm.spmm(tb, B)
    y_ref = ksp.bsr_spmm_ref(tb, B)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == plan_launches({"bsr_spmm": 1})
    assert y.dtype == y_ref.dtype and y.shape == (m.shape[0], m_rhs)
    assert rel_err(y.cpu(), y_ref.cpu()) < TOL[dtype]
    assert torch.equal(tsm.spmm(tb, B), y)          # reruns bitwise


def power_law_row(n=3000, seed=7):
    """A few entries per row, and row 1234 holding a quarter of all columns."""
    m = scattered(n, n, 0.002, seed).tolil()
    rng = np.random.default_rng(seed)
    m[1234, rng.choice(n, n // 4, replace=False)] = rng.standard_normal(n // 4)
    return m.tocsr().astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_walks_a_long_power_law_row(cuda, dtype):
    m = power_law_row()
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(m, device=cuda)).astype(dtype)
    B = torch.randn(m.shape[1], 40, device=cuda, dtype=dtype)
    y = tsm.spmm(tb, B)
    assert rel_err(y.cpu(), ksp.bsr_spmm_ref(tb, B).cpu()) < TOL[dtype]
    assert rel_err(y.cpu(), m.astype(np.float64) @ B.double().cpu().numpy()) < TOL[dtype]
    assert torch.equal(tsm.spmm(tb, B), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_takes_an_unaligned_b(cuda, dtype):
    """B whose rows do not start on 16 bytes: the scalar path."""
    m = MATRICES["blocky_100x300"]()
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(m, device=cuda)).astype(dtype)
    B = torch.randn(300 * 128 + 1, device=cuda, dtype=dtype)[1:].view(300, 128)
    assert B.is_contiguous() and B.data_ptr() % 16
    assert rel_err(tsm.spmm(tb, B).cpu(), ksp.bsr_spmm_ref(tb, B).cpu()) < TOL[dtype]


@pytest.mark.cuda
def test_cuda_kernel_gives_a_csr_spmm_answer_on_non_finite_b(cuda):
    """Where B holds inf or NaN, an unstored zero of a stored block adds
    nothing (scipy's and torch.sparse.mm's answer), a stored zero gives
    0 · inf = NaN; the plain version's dense blocks give NaN for both."""
    m = with_stored_zero().tocoo()
    free = 150                                          # no entry reads it; block column 1 does
    keep = m.col != free
    m = sp.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    z = int(np.flatnonzero(m.data == 0)[0])             # a stored zero
    r0, c0 = int(np.searchsorted(m.indptr, z, side="right") - 1), int(m.indices[z])
    B = np.ones((200, 3), np.float32)
    B[c0, 0] = np.inf
    B[free, 1] = np.nan
    want = m @ B
    assert np.isnan(want[r0, 0]) and not np.isnan(want[:, 1]).any()
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(m, device=cuda))
    Bt = torch.from_numpy(B).to(cuda)
    got = tsm.spmm(tb, Bt).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)
    assert torch.isnan(ksp.bsr_spmm_ref(tb, Bt)[:, 1]).any()


@pytest.mark.cuda
def test_cuda_device_freeze_matches_host_freeze(cuda):
    m = empty_block_rows()
    csr = tsm.CSR.from_scipy(m, device=cuda)
    for br in (8, 64, 256):
        host, dev = tsm.BSR.from_csr(csr, br=br), tsm.BSR.from_csr_device(csr, br=br)
        assert torch.equal(host.blocks, dev.blocks)
        B = torch.randn(520, 17, device=cuda)
        assert torch.equal(tsm.spmm(host, B), tsm.spmm(dev, B))


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    tb = tsm.BSR.from_csr(tsm.CSR.from_scipy(MATRICES["blocky_64x256"](), device=cuda))
    with pytest.raises(ValueError):
        tsm.spmm(tb, torch.zeros(256, 4))                    # B on the CPU
    with pytest.raises(TypeError):
        tsm.spmm(tb, torch.zeros(256, 4, dtype=torch.int32, device=cuda))
