"""The port's assembly and freezes against the JAX package on the same
inputs: builder → CSR → DIA arrays must be equal (not close), element for
element and dtype for dtype, because both freezes are the same host-side
numpy program.  Also the canonicalization helpers, ``from_reference``, the
stored-zero rule of ``DIA.to_coo``, and that the port never imports jax."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparsemat_tpu as jsm
from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu.formats import base as jbase
from sparsemat_tpu_torch import native, types
from sparsemat_tpu_torch.formats import base as tbase
from sparsemat_tpu_torch.interop import from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def poisson_triplets(n):
    """2-D 5-point Poisson on an n×n grid, one stencil arm after another
    (not row-major, so the freeze has to sort)."""
    m = n * n
    i = np.arange(m)
    arms = [(0, np.ones(m, bool), 4.0), (-n, i >= n, -1.0), (n, i < m - n, -1.0),
            (-1, i % n != 0, -1.0), (1, i % n != n - 1, -1.0)]
    r = np.concatenate([i[k] for _, k, _ in arms])
    c = np.concatenate([i[k] + off for off, k, _ in arms])
    v = np.concatenate([np.full(k.sum(), val) for _, k, val in arms])
    return r, c, v


def band_triplets(n, offs, seed=0):
    rng = np.random.default_rng(seed)
    rs, cs, vs = [], [], []
    for off in offs:
        i = np.arange(max(0, -off), min(n, n - off))
        rs.append(i)
        cs.append(i + off)
        vs.append(rng.standard_normal(i.size))
    return np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)


CASES = {
    "poisson16": lambda: poisson_triplets(16),
    "band5000": lambda: band_triplets(5000, (-64, -1, 0, 1, 64)),
    "sublane300": lambda: band_triplets(300, (-7, 0, 13), seed=1),
    "straddle2048": lambda: band_triplets(2048, (-129, -127, 0, 127, 129), seed=2),
}


def assemble(pkg, triplets, **kw):
    b = pkg.SparseBuilder(**kw)
    b.add_batch(*triplets)
    return b


def assert_same(t, j):
    j = np.asarray(j)
    t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_builder_csr_dia_freezes_equal_reference(case):
    trip = CASES[case]()
    jc = assemble(jsm, trip).to_csr()
    tc = assemble(tsm, trip).to_csr()
    assert tc.shape == jc.shape
    for f in ("indptr", "indices", "data", "row_ids"):
        assert_same(getattr(tc, f), getattr(jc, f))
    jd, td = jc.to_dia(), tc.to_dia()
    assert td.offsets == tuple(jd.offsets)
    assert_same(td.data, jd.data)


def test_builder_to_coo_with_padding_equals_reference():
    trip = band_triplets(200, (-3, 0, 5), seed=3)
    jc = assemble(jsm, trip).to_coo(pad_to=700)
    tc = assemble(tsm, trip).to_coo(pad_to=700)
    for f in ("rows", "cols", "vals"):
        assert_same(getattr(tc, f), getattr(jc, f))
    assert_same(tc.to_csr().indptr, jc.to_csr().indptr)


def test_python_store_equals_native_store(monkeypatch):
    trip = poisson_triplets(6)
    b_native = assemble(tsm, trip)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    b_py = assemble(tsm, trip)
    assert b_native.native and not b_py.native
    for f in ("indptr", "indices", "data", "row_ids"):
        assert torch.equal(getattr(b_py.to_csr(), f), getattr(b_native.to_csr(), f))
    assert list(b_py.iter_row(7)) == list(b_native.iter_row(7))


def test_builder_semantics_match_reference():
    """Insertion-order rows, set/add_to, get_row as a SparseVec, and the
    column-info staleness rule, side by side with the JAX builder."""
    bs = [pkg.SparseBuilder() for pkg in (jsm, tsm)]
    for b in bs:
        b.add_to(0, 2, 1.5)
        b.add_to(0, 0, 2.0)
        b.set(2, 1, 3.0)
        b.add_to(0, 2, 0.25)
        b.sort_row(2)
        b.add_to(2, 0, 1.0)
    jb, tb = bs
    assert tb.shape == jb.shape == (3, 3)
    for i in range(3):
        assert list(tb.iter_row(i)) == list(jb.iter_row(i))
    row = tb.get_row(0)
    assert isinstance(row, tsm.SparseVec)
    np.testing.assert_array_equal(row.indices, jb.get_row(0).indices)
    np.testing.assert_array_equal(row.vals, jb.get_row(0).vals)
    with pytest.raises(RuntimeError, match="assemble_column_info"):
        next(tb.iter_col(0))
    tb.assemble_column_info()
    jb.assemble_column_info()
    assert list(tb.iter_col(0)) == list(jb.iter_col(0))
    np.testing.assert_array_equal(tb.todense(), jb.todense())


def test_from_scipy_equals_reference():
    m = sp.random(300, 200, density=0.03, random_state=4, format="csr",
                  dtype=np.float32)
    jc, tc = jsm.CSR.from_scipy(m), tsm.CSR.from_scipy(m)
    for f in ("indptr", "indices", "data", "row_ids"):
        assert_same(getattr(tc, f), getattr(jc, f))


def test_coo_to_csr_with_duplicates_equals_reference():
    rng = np.random.default_rng(5)
    r = rng.integers(0, 30, 200).astype(np.int32)
    c = rng.integers(0, 20, 200).astype(np.int32)
    v = rng.standard_normal(200).astype(np.float32)
    jc = jsm.COO.from_arrays(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
                             (30, 20)).to_csr()
    tc = tsm.COO.from_arrays(r, c, v, (30, 20)).to_csr()
    for f in ("indptr", "indices", "row_ids"):
        assert_same(getattr(tc, f), getattr(jc, f))
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data), rtol=1e-6)


def test_canonicalization_helpers_equal_reference():
    rng = np.random.default_rng(6)
    shape = (40, 30)
    r = np.concatenate([rng.integers(0, 40, 150), np.full(10, 40)]).astype(np.int32)
    c = np.concatenate([rng.integers(0, 30, 150), np.zeros(10)]).astype(np.int32)
    v = np.concatenate([rng.standard_normal(150), np.zeros(10)]).astype(np.float64)
    jr, jc_, jv = jbase.sort_coo(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v), shape)
    tr, tc_, tv = tbase.sort_coo(torch.from_numpy(r), torch.from_numpy(c),
                                 torch.from_numpy(v), shape)
    for t, j in ((tr, jr), (tc_, jc_), (tv, jv)):
        assert_same(t, j)
    jout = jbase.dedup_sorted_coo(jr, jc_, jv, shape)
    tout = tbase.dedup_sorted_coo(tr, tc_, tv, shape)
    for t, j in zip(tout[:2], jout[:2]):
        assert_same(t, j)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=1e-12)
    assert tout[3] == int(jout[3])
    indptr = tbase.rows_to_indptr(tout[0], shape[0])
    assert_same(indptr, jbase.rows_to_indptr(jout[0], shape[0]))
    assert_same(tbase.indptr_to_rows(indptr, 160),
                jbase.indptr_to_rows(jnp.asarray(indptr.numpy()), 160))


@pytest.mark.parametrize("fmt", ["coo", "csr", "dia"])
def test_from_reference_round_trips(fmt):
    m = sp.diags([np.arange(1.0, 51.0), np.ones(49), -np.ones(47)], [0, 1, -3],
                 shape=(50, 50), format="csr").astype(np.float32)
    jcsr = jsm.CSR.from_scipy(m)
    jmat = {"coo": jcsr.to_coo(), "csr": jcsr, "dia": jcsr.to_dia()}[fmt]
    names = {"coo": ("rows", "cols", "vals"),
             "csr": ("indptr", "indices", "data", "row_ids"),
             "dia": ("data", "tdata")}[fmt]
    fields = {f: np.asarray(getattr(jmat, f)) for f in names}
    tmat = from_reference(fields, format=fmt, shape=jmat.shape,
                          offsets=getattr(jmat, "offsets", None))
    for f in names:
        if f != "tdata":
            assert_same(getattr(tmat, f), fields[f])
    x = np.linspace(-1.0, 1.0, 50).astype(np.float32)
    np.testing.assert_allclose(tsm.spmv(tmat, torch.from_numpy(x)).numpy(),
                               m @ x, rtol=1e-6, atol=1e-6)


def test_from_reference_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown"):
        from_reference({"data": np.zeros((1, 4)), "extra": np.zeros(4)},
                       format="dia", shape=(4, 4), offsets=(0,))
    with pytest.raises(ValueError, match="offsets"):
        from_reference({"data": np.zeros((1, 4))}, format="dia", shape=(4, 4))


def test_dia_to_coo_skips_stored_zeros():
    data = np.array([[0.0, 5.0, 6.0, 0.0], [1.0, 0.0, 3.0, 4.0], [5.0, 6.0, 0.0, 9.0]],
                    np.float32)   # offsets (-1, 0, 1); stored zeros and an out-of-range 9
    td = tsm.DIA(data=torch.from_numpy(data), offsets=(-1, 0, 1), shape=(4, 4))
    jd = jsm.DIA(data=jnp.asarray(data), offsets=(-1, 0, 1), shape=(4, 4))
    tcoo, jcoo = td.to_coo(), jd.to_coo()
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tcoo, f).numpy(), np.asarray(getattr(jcoo, f)))
    assert tcoo.n_non_zero_entries() == 7
    np.testing.assert_array_equal(td.todense().numpy(), np.asarray(jd.todense()))
    assert_same(td.to_csr().indptr, jd.to_csr().indptr)


def test_csr_from_arrays_rejects_malformed():
    with pytest.raises(ValueError, match="malformed"):
        tsm.CSR.from_arrays(np.array([0, 2, 1]), np.array([0, 1]),
                            np.array([1.0, 2.0]), (2, 2))


def test_dtype_policy_matches_reference():
    from sparsemat_tpu import types as jtypes

    assert types.accum_dtype(torch.bfloat16) == torch.float32
    assert types.accum_dtype(torch.float16) == torch.float32
    assert types.accum_dtype(torch.float64) == torch.float64
    assert types.DEFAULT_INDEX_DTYPE == torch.int32
    for dt in ("int8", "int16", "int32", "int64"):
        assert types.unset_value(getattr(torch, dt)) == jtypes.unset_value(dt)
    for dt in ("float32", "float64", "float16", "int32"):
        assert types.is_float_dtype(getattr(torch, dt)) == jtypes.is_float_dtype(dt)


def test_import_leaves_jax_out():
    code = ("import sys, sparsemat_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('sparsemat_tpu.') or m == 'sparsemat_tpu']; "
            "sys.exit(repr(bad) if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
