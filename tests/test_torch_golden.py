"""The reference library's golden values through the port's formats: the
SpMV values 34.544 and 20.16 and the densities 6/9 and 5/16 (the same
matrices as ``tests/test_golden.py``), the builder's set/add_to sequence
that makes the 3×3 matrix, the vector types, and the algebra's goldens:
SpGEMM ``get(1, 2) == 17.9632``, the dimension guard, the cross-format add
(row 1 ``[0, 4.48, 8.24]``), the transpose round trip, ``is_symmetric``
and the operators ``+``, ``-``.  Tolerance rel 1e-6: f32 sums of three
terms."""

import numpy as np
import pytest
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm

X3 = torch.tensor([2.0, 4.8, 1.2])
X4 = torch.tensor([2.0, 4.8, 1.2, 3.4])


def build_indexlist_matrix(format="coo"):
    """Final (0,0)=7.12 (0,1)=4.2 (0,2)=0.12 (1,1)=2.24 (1,2)=4.12 (2,2)=2.12."""
    coo = tsm.COO.from_arrays(np.array([0, 0, 0, 1, 1, 2], np.int32),
                              np.array([0, 1, 2, 1, 2, 2], np.int32),
                              np.array([7.12, 4.2, 0.12, 2.24, 4.12, 2.12], np.float32),
                              (3, 3), canonical=True)
    return coo if format == "coo" else getattr(coo, f"to_{format}")()


def build_crs_matrix(format="csr"):
    """The 4×4 matrix of the reference's CRS check."""
    coo = tsm.COO.from_arrays(np.array([0, 2, 1, 3, 3], np.int32),
                              np.array([1, 2, 2, 2, 3], np.int32),
                              np.array([4.2, 2.12, 4.12, 1.12, 5.12], np.float32),
                              (4, 4))
    return coo if format == "coo" else getattr(coo, f"to_{format}")()


FORMATS = ["coo", "csr", "dia"]


@pytest.mark.parametrize("format", FORMATS)
def test_spmv_golden_3x3(format):
    y = tsm.spmv(build_indexlist_matrix(format), X3)
    assert y.shape == (3,)
    np.testing.assert_allclose(y.numpy(), [34.544, 15.696, 2.544], rtol=1e-6)


@pytest.mark.parametrize("format", FORMATS)
def test_spmv_golden_4x4(format):
    y = tsm.spmv(build_crs_matrix(format), X4)
    np.testing.assert_allclose(y.numpy()[0], 20.16, rtol=1e-6)


@pytest.mark.parametrize("format", FORMATS)
def test_density_golden(format):
    assert build_indexlist_matrix(format).density() == pytest.approx(6 / 9)
    assert build_crs_matrix(format).density() == pytest.approx(5 / 16)


def test_builder_golden_sequence():
    """add_to(0,1,4.2); add_to(1,2,4.12); add_to(2,2,2.12); add_to(1,1,1.12);
    (1,1)+=1.12; (0,2)+=0.12; (0,0)=8.12; set(0,0,7.12)."""
    b = tsm.SparseBuilder()
    b.add_to(0, 1, 4.2)
    b.add_to(1, 2, 4.12)
    b.add_to(2, 2, 2.12)
    b.add_to(1, 1, 1.12)
    b.add_to(1, 1, 1.12)
    b.add_to(0, 2, 0.12)
    b[0, 0] = 8.12
    b.set(0, 0, 7.12)
    assert b.get(0, 0) == pytest.approx(7.12, rel=1e-6)
    for mat in (b.to_csr(), b.to_csr().to_dia()):
        np.testing.assert_allclose(tsm.spmv(mat, X3).numpy(),
                                   [34.544, 15.696, 2.544], rtol=1e-6)
        assert mat.density() == pytest.approx(6 / 9)
    np.testing.assert_allclose((b.to_csr() @ X3).numpy(), b.mvp(X3).numpy())


def test_eye_and_from_dense():
    np.testing.assert_allclose(tsm.eye(3).todense().numpy(), np.eye(3))
    np.testing.assert_allclose((tsm.eye(3, format="coo") @ X3).numpy(), X3.numpy())
    dense = np.array([[4.0, 1.0], [1.0, 3.0]], np.float32)
    for fmt in ("csr", "coo", "dia"):
        np.testing.assert_array_equal(tsm.from_dense(dense, format=fmt).todense().numpy(),
                                      dense)


def test_sparsevec_golden():
    sv = tsm.SparseVec.empty(dtype=np.float64)
    sv.set(8, 6.0)
    sv.set(80, 6.4)
    sv.set(55, 8.2)
    sv.set(4, 4.0)
    it = sv.iter_sparse()
    assert next(it) == (8, 6.0)
    assert next(it) == (80, 6.4)
    assert sv.get(4) == 4.0


def test_densevec_and_norms():
    v = tsm.DenseVec(dtype=np.float64)
    v.set(0, 1.0)
    v.set(3, 2.0)
    assert v.dim == 4
    assert v.get(1) == 0.0
    v.add_to(1, 0.5)
    assert v.get(1) == 0.5
    with pytest.raises(ValueError):
        tsm.DenseVec([1.0]).add(tsm.DenseVec([1.0, 2.0]))
    t = v.to_torch()
    assert float(tsm.vectors.inner_prod(t, t)) == pytest.approx(5.25)
    assert float(tsm.norm(t)) == pytest.approx(5.25 ** 0.5)
    assert float(tsm.norm_squared(torch.ones(4, dtype=torch.bfloat16))) == 4.0


# -- the algebra (tests/test_golden.py's operator and algebra goldens) ------------------

def test_operator_overloads_golden():
    sp = build_indexlist_matrix("csr")
    total = sp + sp
    assert total.get(0, 0) == pytest.approx(14.24, rel=1e-6)
    assert (total - sp).get(0, 0) == pytest.approx(sp.get(0, 0), rel=1e-6)
    assert (sp * 2.0).get(0, 0) == pytest.approx(total.get(0, 0), rel=1e-6)


@pytest.mark.parametrize("kw", [{}, {"max_fanout_slots": 1}], ids=["oneshot", "esc"])
def test_spgemm_golden(kw):
    sp = build_indexlist_matrix("coo")
    mp = tsm.spgemm(sp.to_csr(), sp, **kw)
    assert mp.get(1, 2) == pytest.approx(17.9632, rel=1e-6)
    dense = sp.todense().numpy()
    np.testing.assert_allclose(mp.todense().numpy(), dense @ dense, rtol=1e-6)
    np.testing.assert_allclose((sp.to_csr() @ sp).todense().numpy(), dense @ dense, rtol=1e-6)


def test_spgemm_dimension_guard():
    a = tsm.COO.from_arrays(np.array([0]), np.array([1]), np.array([1.0]), (2, 3))
    b = tsm.COO.from_arrays(np.array([0]), np.array([1]), np.array([1.0]), (2, 3))
    with pytest.raises(tsm.DimensionError):
        tsm.spgemm(a, b)


def test_cross_format_add_golden():
    s = tsm.add(build_indexlist_matrix("coo"), build_indexlist_matrix("csr"))
    np.testing.assert_allclose(s.todense().numpy()[1], [0.0, 4.48, 8.24], rtol=1e-6)


def test_transpose_roundtrip_golden():
    sp = build_crs_matrix("csr")
    t = tsm.transpose(sp)
    np.testing.assert_allclose(t.todense().numpy(), sp.todense().numpy().T, rtol=1e-6)
    np.testing.assert_allclose(tsm.transpose(t).todense().numpy(), sp.todense().numpy(),
                               rtol=1e-6)


def test_is_symmetric_golden():
    assert bool(tsm.is_symmetric(tsm.from_dense(np.array([[4.0, 1.0], [1.0, 3.0]]))))
    assert not bool(tsm.is_symmetric(tsm.from_dense(np.array([[4.0, 1.0], [2.0, 3.0]]))))
