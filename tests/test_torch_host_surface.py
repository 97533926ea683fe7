"""The port's host surface against the JAX package's on the same inputs:
``RowVec`` (the cases of ``tests/test_rowvec.py``, with its freezes' arrays
equal to the JAX package's), the CSR row and column access and ``prune``,
``COO.prune`` / ``with_padding_to``, the dtype policy, and the timing
helpers.  Arrays are equal; values looked up and summed are
equal or, for f32 SpMV sums of three terms, within rel 1e-6.

The builder's ``TypeError`` for a complex value dtype and an unsigned index
dtype is the port's alone: the JAX builder takes both without a check.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import LazyModule, port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import types
from sparsemat_tpu_torch.formats.rowvec import RowVec
from sparsemat_tpu_torch.utils import profiling as tprof

jnp = LazyModule("jax.numpy")
jsm = LazyModule("sparsemat_tpu")
jtypes = LazyModule("sparsemat_tpu.types")

X3 = [2.0, 4.8, 1.2]


def assert_arrays(t, j, fields):
    for f in fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert b.dtype == a.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


# -- RowVec ------------------------------------------------------------------------------

def build_reference_rowvec(cls):
    """The reference library's assembly sequence."""
    m = cls()
    m.add_to(0, 1, 4.2)
    m.add_to(1, 2, 4.12)
    m.add_to(2, 2, 2.12)
    m.add_to(1, 1, 1.12)
    m.add_to(1, 1, 1.12)
    m.add_to(0, 2, 0.12)
    m.add_to(0, 0, 8.12)
    m.set(0, 0, 7.12)
    return m


def both_rowvecs():
    return build_reference_rowvec(jsm.RowVec), build_reference_rowvec(RowVec)


def test_rowvec_assembly_semantics():
    j, t = both_rowvecs()
    assert t.shape == j.shape == (3, 3) and t.nnz == j.nnz == 6
    for i, k in ((0, 0), (1, 1), (2, 0), (0, 2)):
        assert t.get(i, k) == j.get(i, k) and type(t.get(i, k)) is type(j.get(i, k))
    assert t[1, 2] == j[1, 2]
    assert list(t) == list(j)


def test_rowvec_insertion_order_and_sorting():
    j, t = both_rowvecs()
    assert [c for c, _ in t.iter_row(0)] == [c for c, _ in j.iter_row(0)] == [1, 2, 0]
    assert not t.is_sorted_row(0) and not j.is_sorted_row(0)
    t.sort_row(0)
    j.sort_row(0)
    assert list(t.iter_row(0)) == list(j.iter_row(0))
    assert t.sort().is_sorted() and j.sort().is_sorted()


def test_rowvec_iter_row_out_of_range_raises():
    _, t = both_rowvecs()
    with pytest.raises(IndexError):
        t.iter_row(5)


def test_rowvec_spmv_and_density_golden():
    j, t = both_rowvecs()
    want = np.asarray(j.mvp(jnp.asarray(X3, jnp.float32)))
    np.testing.assert_allclose(t.mvp(X3).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(t.mvp(X3).numpy(), [34.544, 15.696, 2.544], rtol=1e-6)
    assert t.density() == j.density() == pytest.approx(6 / 9)
    assert t.sparsity() == j.sparsity()


def test_rowvec_push_keeps_duplicates():
    t, j = RowVec(), jsm.RowVec()
    for m in (t, j):
        m.push(0, 0, 1.0)
        m.push(0, 0, 2.0)
    assert t.nnz == j.nnz == 2
    assert_arrays(t.to_csr(), j.to_csr(), ("indptr", "indices", "data", "row_ids"))
    np.testing.assert_allclose(t.to_csr().todense().numpy(), [[3.0]])


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_rowvec_freezes_equal_reference(dt):
    j, t = (build_reference_rowvec(lambda: cls(dtype=dt)) for cls in (jsm.RowVec, RowVec))
    t.push(4, 1, 0.5)             # an empty row 3, a pushed duplicate in row 0
    j.push(4, 1, 0.5)
    t.push(0, 1, 1.5)
    j.push(0, 1, 1.5)
    assert_arrays(t.to_csr(), j.to_csr(), ("indptr", "indices", "data", "row_ids"))
    assert_arrays(t.to_coo(), j.to_coo(), ("rows", "cols", "vals"))
    assert_arrays(t.to_ell(), j.to_ell(), ("cols", "vals", "row_nnz"))
    assert_arrays(t.freeze("coo"), j.freeze("coo"), ("rows", "cols", "vals"))
    np.testing.assert_array_equal(t.todense(), j.todense())
    assert t.to_csr(device="cpu").device.type == "cpu"


def test_rowvec_eye_scale_get_row_and_capacity():
    t, j = RowVec.eye(3), jsm.RowVec.eye(3)
    t.scale(2.5)
    j.scale(2.5)
    np.testing.assert_array_equal(t.todense(), j.todense())
    _, r = both_rowvecs()
    jr = build_reference_rowvec(jsm.RowVec)
    sv, jv = r.get_row(1), jr.get_row(1)
    assert sorted(sv.iter_sparse()) == sorted(jv.iter_sparse())
    assert sv.dim == jv.dim
    m = RowVec.with_capacity(4)
    assert m.n_rows == 4 and list(m.iter_row(3)) == []
    m.push(1, 0, 1.0)
    assert m.shape == (4, 1)


def test_rowvec_freeze_is_sorted():
    _, t = both_rowvecs()
    csr = t.to_csr()
    assert bool(tsm.is_sorted(csr))
    assert all(bool(tsm.is_sorted_row(csr, i)) for i in range(3))


def test_rowvec_entry_points_need_a_card(monkeypatch):
    from _torch_cpu import real_default_device

    monkeypatch.setattr(types, "default_device", real_default_device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t = both_rowvecs()
    for call in (t.to_csr, t.to_coo, t.to_ell, lambda: t.mvp(X3)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


# -- CSR / COO host methods --------------------------------------------------------------

def matrix(dt=np.float64):
    """Empty rows 2 and 5, a stored zero, an empty last column."""
    m = sp.random(8, 7, 0.4, format="csr", random_state=np.random.default_rng(3), dtype=dt)
    m = m.tolil()
    m[2, :] = 0
    m[5, :] = 0
    m[:, 6] = 0
    m = m.tocsr()
    m.eliminate_zeros()
    m.data[1] = 0.0
    return m


def both_csr(m):
    return jsm.CSR.from_scipy(m), tsm.CSR.from_scipy(m)


def test_csr_rows_equal_reference():
    j, t = both_csr(matrix())
    for i in range(8):
        np.testing.assert_array_equal(t.get_row_dense(i).numpy(), np.asarray(j.get_row_dense(i)))
        jv, tv = j.get_row(i), t.get_row(i)
        assert isinstance(tv, tsm.SparseVec) and tv.dim == jv.dim
        np.testing.assert_array_equal(tv.indices, jv.indices)
        np.testing.assert_array_equal(tv.vals, jv.vals)
        assert list(t.iter_row(i)) == list(j.iter_row(i))
    assert list(t.iter_row(8)) == list(j.iter_row(8)) == []
    assert list(t.iter_row(-1)) == []


def test_csr_column_view_equals_reference():
    j, t = both_csr(matrix())
    with pytest.raises(RuntimeError, match="assemble_column_info"):
        next(t.iter_col(2))
    assert t.assemble_column_info() is t
    j.assemble_column_info()
    for c in range(8):
        assert list(t.iter_col(c)) == list(j.iter_col(c))
    assert list(t.iter_col(6)) == []


@pytest.mark.parametrize("keep_zeros", [True, False])
def test_prune_equals_reference(keep_zeros):
    j, t = both_csr(matrix())
    jc = j.to_coo().with_padding_to(j.nse + 5)
    tc = t.to_coo().with_padding_to(t.nse + 5)
    assert_arrays(tc, jc, ("rows", "cols", "vals"))
    assert tc.nse == jc.nse and tc.canonical == jc.canonical
    assert_arrays(tc.prune(keep_zeros=keep_zeros), jc.prune(keep_zeros=keep_zeros),
                  ("rows", "cols", "vals"))
    jp = jsm.CSR.from_coo(jc).prune(keep_zeros=keep_zeros)
    tp = tsm.CSR.from_coo(tc).prune(keep_zeros=keep_zeros)
    assert_arrays(tp, jp, ("indptr", "indices", "data", "row_ids"))
    assert tc.with_padding_to(tc.nse) is tc
    with pytest.raises(ValueError, match="prune"):
        tc.with_padding_to(3)


# -- the dtype policy --------------------------------------------------------------------

def test_dtype_lists_equal_reference():
    names = lambda dts: [np.dtype(d).name if d is not jnp.bfloat16 else "bfloat16"  # noqa: E731
                         for d in dts]
    assert [str(d).replace("torch.", "") for d in types.INDEX_DTYPES] == names(jtypes.INDEX_DTYPES)
    assert [str(d).replace("torch.", "") for d in types.VALUE_DTYPES] == names(jtypes.VALUE_DTYPES)
    for dt in ("int8", "int16", "int32", "int64"):
        want = np.dtype(jtypes.compute_index_dtype(dt)).name
        assert str(types.compute_index_dtype(getattr(torch, dt))) == f"torch.{want}"
        assert types.check_index_dtype(dt) == getattr(torch, dt)
    for dt in ("float32", "float64", "float16", "int8", "int64"):
        assert types.check_value_dtype(np.dtype(dt)) == getattr(torch, dt)
    assert types.check_value_dtype("bfloat16") == torch.bfloat16


@pytest.mark.parametrize("bad", [np.complex64, np.uint8, np.bool_, torch.uint8, "float8"])
def test_unsupported_dtypes_raise_a_type_error_that_names_them(bad):
    for check in (types.check_index_dtype, types.check_value_dtype):
        with pytest.raises(TypeError, match="unsupported"):
            check(bad)


def test_builder_refuses_unsupported_dtypes():
    with pytest.raises(TypeError, match="value dtype.*complex64"):
        tsm.SparseBuilder(4, dtype=np.complex64)
    with pytest.raises(TypeError, match="index dtype.*uint8"):
        tsm.SparseBuilder(4, index_dtype=np.uint8)
    with pytest.raises(TypeError, match="index dtype"):
        tsm.SparseBuilder(4, index_dtype=torch.float32)
    b = tsm.SparseBuilder(4, dtype=np.float64, index_dtype=np.int16)
    assert (b.dtype, b.index_dtype) == (torch.float64, torch.int16)


def test_type_policy():
    p = types.TypePolicy(np.float64, "int16")
    assert (p.dtype, p.index_dtype) == (torch.float64, torch.int16)
    assert p.unset == jtypes.TypePolicy(jnp.float64, jnp.int16).unset == 32767
    assert types.DEFAULT_POLICY == types.TypePolicy(torch.float32, torch.int32)
    with pytest.raises(TypeError):
        types.TypePolicy(np.complex128)
    with pytest.raises(TypeError):
        types.TypePolicy(index_dtype=np.uint32)


# -- profiling ---------------------------------------------------------------------------

def test_timing_refuses_the_host():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        tprof.time_chained_op(lambda v: v, x)
    with pytest.raises(ValueError, match="CUDA"):
        tprof.dispatch_rtt()                    # the tests' default device is the CPU
    assert tprof.sync(torch.tensor([3.0, 1.0])) == 3.0


def test_trace_to_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with tprof.trace_to(str(path)):
        torch.ones(8).add_(1)
    assert path.exists() and path.stat().st_size > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_timing_helpers(cuda):
    assert 0 < tprof.dispatch_rtt(cuda) < 1e-2
