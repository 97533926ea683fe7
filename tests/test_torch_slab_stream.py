"""The port's SlabStream against the JAX package's on the same inputs: the
freeze gives the same arrays bit for bit (rb 128 and 256, a rectangular
matrix, stored zeros and the one-zero-chunk layout of nnz = 0 included);
the plain SpMV matches the XLA oracle and the Pallas kernel in interpret
mode (with the JAX package's per-call chunk splits forced); round trips
keep stored zeros; the CUDA kernel's walk (the row-group plan built from
``to_coo``, walked in the kernel's order) gives A @ x for chunks in and out
of block order, and chunks in any order give one plan; and (on a CUDA card)
the kernel matches the plain version and its plan's walk.

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
from sparsemat_tpu_torch.formats.slab import SUBLANE
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.kernels import slab as ksl

STREAM_ARRAYS = ("vals", "lidx", "win_id", "blk_id", "cnt8")


def mixed_degree(n=2000, seed=0):
    """tests/test_gell_pack.py's matrices: interleaved light and heavy rows."""
    rng = np.random.default_rng(seed)
    deg = np.where(np.arange(n) % 7, 3, 60)
    rows = np.repeat(np.arange(n), deg)
    cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def stored_zero():
    m = mixed_degree(600, 3)
    m.data[[0, 5, 77]] = 0.0                # stored entries whose value is zero
    return m


MATRICES = {
    "mixed_2000": lambda: mixed_degree(2000, 0),
    "mixed_1100": lambda: mixed_degree(1100, 22),
    "rect_300x900": lambda: sp.random(300, 900, 0.02, format="csr", dtype=np.float32,
                                      random_state=np.random.default_rng(4)),
    "rect_900x200": lambda: sp.random(900, 200, 0.03, format="csr", dtype=np.float32,
                                      random_state=np.random.default_rng(5)),
    "stored_zero": stored_zero,
    "empty": lambda: sp.csr_matrix((300, 200), dtype=np.float32),
}
#: (matrix, rb) pairs of the cases: tests/test_gell_pack.py's two, and the rest at both rb
CASES = [("mixed_2000", 256), ("mixed_1100", 128)] + [
    (name, rb) for name in ("rect_300x900", "rect_900x200", "stored_zero", "empty")
    for rb in (128, 256)]


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


def streams(m, rb=256):
    jsm, _ = jax_ref()
    return (jsm.SlabStream.from_csr(jsm.CSR.from_scipy(m), rb=rb),
            tsm.SlabStream.from_csr(tsm.CSR.from_scipy(m), rb=rb))


def assert_stream_equal(js, ts):
    assert ts.shape == tuple(js.shape) and ts.row_block == js.row_block
    for f in STREAM_ARRAYS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


# -- the freeze ------------------------------------------------------------------

@pytest.mark.parametrize("name,rb", CASES)
def test_slab_stream_freeze_equals_reference(name, rb):
    m = MATRICES[name]()
    js, ts = streams(m, rb)
    assert_stream_equal(js, ts)
    assert (ts.nse, ts.n_chunks, ts.n_row_blocks, ts.x_windows()) == \
        (js.nse, js.n_chunks, js.n_row_blocks, js.x_windows())
    assert ts.n_non_zero_entries() == int(js.n_non_zero_entries()) == m.nnz
    assert ts.fill_ratio() == pytest.approx(js.fill_ratio(), rel=1e-12)


def test_nnz0_is_one_zero_chunk():
    js, ts = streams(MATRICES["empty"](), 128)
    assert ts.n_chunks == 1 and not ts.vals.any() and not ts.cnt8.any()
    assert_stream_equal(js, ts)


def test_freeze_of_f64_and_bf16_values():
    m = mixed_degree(1100, 22).astype(np.float64)
    js, ts = streams(m, 128)
    assert_stream_equal(js, ts)
    assert ts.dtype == torch.float64
    bf = tsm.CSR.from_scipy(m).astype(torch.bfloat16).to_slab_stream(rb=128)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf.lidx, ts.lidx)
    np.testing.assert_array_equal(bf.vals.float().numpy(),
                                  ts.vals.to(torch.bfloat16).float().numpy())


def test_rb_must_be_a_multiple_of_128():
    jsm, _ = jax_ref()
    m = mixed_degree(300, 1)
    for pkg in (jsm, tsm):
        with pytest.raises(ValueError, match="multiple of 128"):
            pkg.SlabStream.from_csr(pkg.CSR.from_scipy(m), rb=64)


def test_exact_heights_beat_the_global_slab():
    """As tests/test_gell_pack.py checks it: exact bucket heights never pad
    more than the global-max heights at the same rb."""
    csr = tsm.CSR.from_scipy(mixed_degree(2000, 21))
    assert csr.to_slab_stream().nse <= csr.to_slab().nse
    assert (csr.to_slab_stream(rb=128).nse
            <= tsm.SlabPack.from_csr(csr, spill_frac=0.0).nse)


# -- the plain version against the JAX package's oracle and kernel ----------------

@pytest.mark.parametrize("name,rb", CASES)
def test_slab_stream_spmv_ref_matches_xla_oracle(name, rb):
    import jax.numpy as jnp

    _, jkv = jax_ref()
    m = MATRICES[name]()
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        js, ts = streams(m.astype(dt), rb)
        x = np.random.default_rng(5).standard_normal(m.shape[1]).astype(dt)
        got = ksl.slab_stream_spmv_ref(ts, torch.from_numpy(x))
        assert got.dtype == torch.from_numpy(x).dtype and got.shape == (m.shape[0],)
        assert rel_err(got, jkv.slab_stream_spmv_xla(js, jnp.asarray(x))) < tol
        assert rel_err(got, m.astype(np.float64) @ x.astype(np.float64)) < tol


@pytest.mark.parametrize("max_chunks", [None, 32])
def test_slab_stream_spmv_ref_matches_pallas_interpret(max_chunks, monkeypatch):
    import jax.numpy as jnp

    _, jkv = jax_ref()
    if max_chunks is not None:                  # the JAX kernel's multi-call split
        monkeypatch.setattr(jkv, "_STREAM_MAX_CHUNKS_PER_CALL", max_chunks)
    m = MATRICES["mixed_1100"]()
    js, ts = streams(m, 128)
    x = np.random.default_rng(23).standard_normal(m.shape[1]).astype(np.float32)
    got = ksl.slab_stream_spmv_ref(ts, torch.from_numpy(x))
    assert rel_err(got, jkv.slab_stream_spmv_pallas(js, jnp.asarray(x), interpret=True)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_matches_xla_oracle(dtype):
    import jax.numpy as jnp

    jsm, jkv = jax_ref()
    m = mixed_degree(1100, 22)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    js = jsm.CSR.from_scipy(m).astype(jdt).to_slab_stream()
    ts = tsm.CSR.from_scipy(m).astype(dtype).to_slab_stream()
    x = np.random.default_rng(9).standard_normal(1100).astype(np.float32)
    got = tsm.spmv(ts, torch.from_numpy(x).to(dtype))
    assert got.dtype == torch.float32
    assert rel_err(got, jkv.slab_stream_spmv_xla(js, jnp.asarray(x).astype(jdt))) < 1e-5


def test_dispatch_and_cpu_wrapper_counts_nothing():
    m = mixed_degree(1100, 22)
    csr = tsm.CSR.from_scipy(m)
    ts = csr.to_slab_stream()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(1100).astype(np.float32))
    rg.reset_launches()
    y = tsm.spmv(ts, x)
    assert torch.equal(y, ksl.slab_stream_spmv_ref(ts, x))
    assert torch.equal(tsm.spmv(csr, x, method="slab_stream"), y)
    assert torch.equal(ts @ x, y)
    yd, d = tsm.spmv_dot(ts, x)
    assert torch.equal(yd, y) and float(d) == pytest.approx(float(x @ y), rel=1e-5)
    B = torch.from_numpy(np.random.default_rng(5).standard_normal((1100, 3)).astype(np.float32))
    assert rel_err(tsm.spmm(ts, B), m @ B.numpy()) < 1e-5          # through CSR
    assert rg.LAUNCHES == plan_launches({"slab_spmv": 0, "slab_spmm": 0,
                                         "slab_stream_spmv": 0, "slab_stream_spmm": 0})


# -- the CUDA kernel's design, replayed on the host ---------------------------------

def shuffled_with_stray(ts):
    """The chunks of ``ts`` shuffled, plus one chunk of stored entries aimed
    at a row block past the last."""
    rb, dev = ts.row_block, ts.vals.device
    perm = torch.from_numpy(np.random.default_rng(7).permutation(ts.n_chunks)).to(dev)
    stray = dict(vals=torch.ones(1, SUBLANE, rb, dtype=ts.vals.dtype, device=dev),
                 lidx=torch.zeros(1, SUBLANE, rb, dtype=torch.int32, device=dev),
                 win_id=torch.zeros(1, dtype=torch.int32, device=dev),
                 blk_id=torch.tensor([ts.n_row_blocks], dtype=torch.int32, device=dev),
                 cnt8=torch.full((1, rb), SUBLANE, dtype=torch.int32, device=dev))
    return dataclasses.replace(
        ts, **{f: torch.cat([getattr(ts, f)[perm], stray[f]]) for f in STREAM_ARRAYS})


@pytest.mark.parametrize("name,rb", [("mixed_1100", 128), ("rect_900x200", 256),
                                     ("empty", 128)])
def test_cuda_design_replay_in_and_out_of_block_order(name, rb):
    """The kernel walks the plan of the stored entries: chunks shuffled out
    of block order, plus a chunk aimed past the last row block (dropped),
    give the plan of the frozen stream array for array, and its walk gives
    A @ x."""
    m = MATRICES[name]().astype(np.float64)
    ts = tsm.CSR.from_scipy(m).to_slab_stream(rb=rb)
    x = np.random.default_rng(6).standard_normal(m.shape[1])
    xt = torch.from_numpy(x)
    want = m @ x
    plan = rg.plan_of(ts)
    assert rel_err(rg.spmv_walk(plan, xt), want) < 1e-12
    shuffled = shuffled_with_stray(ts)
    got = rg.plan_of(shuffled)
    assert got.nnz == plan.nnz == m.nnz                    # the stray chunk is dropped
    for f in ("grp_ptr", "cols", "mask", "vals"):
        assert torch.equal(getattr(got, f), getattr(plan, f)), f
    assert rel_err(rg.spmv_walk(got, xt), want) < 1e-12
    assert rel_err(ksl.slab_stream_spmv_ref(shuffled, xt), want) < 1e-12


# -- canonical views and structure ----------------------------------------------------

@pytest.mark.parametrize("name", ["stored_zero", "mixed_1100", "rect_900x200", "empty"])
def test_to_csr_round_trip(name):
    m = MATRICES[name]()
    m.sort_indices()
    ts = tsm.CSR.from_scipy(m).to_slab_stream(rb=128)
    back = ts.to_csr()
    got = sp.csr_matrix((back.data.numpy(), back.indices.numpy(), back.indptr.numpy()),
                        shape=back.shape)
    assert back.shape == m.shape
    assert back.n_non_zero_entries() == ts.n_non_zero_entries() == m.nnz  # stored zeros kept
    assert (got != m).nnz == 0
    np.testing.assert_array_equal(ts.todense().numpy(), m.toarray())


def test_to_coo_equals_reference():
    js, ts = streams(stored_zero(), 128)
    jc, tc = js.to_coo(), ts.to_coo()
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))


def test_scale_astype_and_traffic_bytes():
    m = mixed_degree(1100, 22)
    ts = tsm.CSR.from_scipy(m).to_slab_stream()
    x = np.random.default_rng(12).standard_normal(1100)
    assert rel_err(tsm.spmv(2.0 * ts, torch.from_numpy(x).float()), 2 * (m @ x)) < 1e-5
    s64 = ts.scale(3.0).astype(torch.float64)
    assert s64.dtype == torch.float64 and torch.equal(s64.cnt8, ts.cnt8)
    assert rel_err(tsm.spmv(s64, torch.from_numpy(x)), 3 * (m.astype(np.float64) @ x)) < 1e-6
    assert ts.spmv_traffic_bytes() == ts.nse * 8 + ts.n_chunks * 8 + 1100 * 4 + 1100 * 4


# -- the CUDA kernel against its plain version (needs a card) -------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("name,rb", CASES)
def test_cuda_kernel_matches_plain(cuda, dtype, name, rb):
    ts = tsm.CSR.from_scipy(MATRICES[name](), device=cuda).to_slab_stream(rb=rb).astype(dtype)
    x = torch.randn(ts.shape[1], device=cuda)
    x = x.to(dtype) if dtype != torch.bfloat16 else x
    rg.reset_launches()
    y = tsm.spmv(ts, x)
    y_ref = ksl.slab_stream_spmv_ref(ts, x)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == plan_launches({"slab_spmv": 0, "slab_spmm": 0,
                                         "slab_stream_spmv": 1, "slab_stream_spmm": 0})
    assert y.dtype == y_ref.dtype and y.shape == (ts.shape[0],)
    assert rel_err(y.cpu(), y_ref.cpu()) < TOL[dtype]
    assert rel_err(y.cpu(), rg.spmv_walk(rg.plan_of(ts), x).cpu()) < TOL[dtype]
    assert torch.equal(tsm.spmv(ts, x), y)           # reruns bitwise


@pytest.mark.cuda
def test_cuda_kernel_takes_chunks_out_of_block_order(cuda):
    ts = tsm.CSR.from_scipy(mixed_degree(1100, 22), device=cuda).to_slab_stream(rb=128)
    shuffled = shuffled_with_stray(ts)
    x = torch.randn(1100, device=cuda)
    y = tsm.spmv(shuffled, x)
    assert rel_err(y.cpu(), ksl.slab_stream_spmv_ref(ts, x).cpu()) < 1e-5
    plan, want = rg.plan_of(shuffled), rg.plan_of(ts)
    assert plan.grp_ptr.device == x.device
    for f in ("grp_ptr", "cols", "mask", "vals"):
        assert torch.equal(getattr(plan, f), getattr(want, f)), f
    assert torch.equal(tsm.spmv(ts, x), y)   # one plan, one answer


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    ts = tsm.CSR.from_scipy(mixed_degree(1100, 22), device=cuda).to_slab_stream()
    with pytest.raises(ValueError):
        tsm.spmv(ts, torch.zeros(1100))                    # x on the CPU
    with pytest.raises(ValueError):
        tsm.spmv(ts, torch.zeros(1101, device=cuda))       # wrong length
    with pytest.raises(TypeError):
        tsm.spmv(ts, torch.zeros(1100, dtype=torch.int32, device=cuda))
