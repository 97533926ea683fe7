"""The port's CG against ``sparsemat_tpu.solvers.cg`` on the same systems,
and the whole slice — SparseBuilder.add_batch → to_csr → to_dia → cg — in
both packages side by side.

Tolerances: the golden 2×2 system to 1e-10 and the f64 Poisson to 1e-8 (the
reference's own assertions); f32 x to rel 1e-5 against the reference's x;
f32 iteration counts equal or within 1 (the two sum pᵀAp and rᵀr in
different orders, so the last residual can cross the threshold one
iteration apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparsemat_tpu as jsm
from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu import solvers as jsolvers
from sparsemat_tpu_torch import solvers


def poisson2d(n, dtype=np.float64):
    m = n * n
    lap = sp.diags([4.0 * np.ones(m), -np.ones(m - 1), -np.ones(m - 1),
                    -np.ones(m - n), -np.ones(m - n)],
                   [0, 1, -1, n, -n], format="lil")
    for k in range(1, n):
        lap[k * n, k * n - 1] = 0
        lap[k * n - 1, k * n] = 0
    out = lap.tocsr().astype(dtype)
    out.eliminate_zeros()
    return out


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_cg_golden():
    A = tsm.from_dense(np.array([[4.0, 1.0], [1.0, 3.0]]))
    b = torch.tensor([1.0, 2.0], dtype=torch.float64)
    x0 = torch.tensor([2.0, 1.0], dtype=torch.float64)
    x, info = solvers.cg(A, b, x0)
    # the reference's exact assertion
    assert np.floor(float(x[0]) * 10000) / 10000 == 0.0909
    np.testing.assert_allclose(x.numpy(), [1 / 11, 7 / 11], atol=1e-10)
    assert bool(info.converged)
    jx, jinfo = jsolvers.cg(jsm.from_dense(np.array([[4.0, 1.0], [1.0, 3.0]])),
                            jnp.array([1.0, 2.0]), jnp.array([2.0, 1.0]))
    assert int(info.iterations) == int(jinfo.iterations)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-12)


def test_cg_class_api_defaults():
    cgobj = tsm.ConjugateGradient()
    assert (cgobj.tol, cgobj.iter_max) == (1e-12, 10_000)
    A = tsm.from_dense(np.array([[4.0, 1.0], [1.0, 3.0]]))
    x, _ = cgobj.solve(A, torch.tensor([1.0, 2.0], dtype=torch.float64),
                       torch.tensor([2.0, 1.0], dtype=torch.float64))
    np.testing.assert_allclose(x.numpy(), [1 / 11, 7 / 11], atol=1e-10)


@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_cg_poisson_f64_matches_reference(fmt):
    lap = poisson2d(24)
    x_true = np.random.default_rng(7).standard_normal(lap.shape[0])
    b = lap @ x_true
    A = tsm.CSR.from_scipy(lap)
    A = A.to_dia() if fmt == "dia" else A
    x, info = solvers.cg(A, torch.from_numpy(b), tol=1e-8)
    assert bool(info.converged) and float(info.residual_norm) < 1e-8
    np.testing.assert_allclose(x.numpy(), x_true, atol=1e-6)
    jx, jinfo = jsolvers.cg(jsm.CSR.from_scipy(lap), jnp.asarray(b), tol=1e-8)
    assert abs(int(info.iterations) - int(jinfo.iterations)) <= 1
    assert rel(x, jx) < 1e-8


def test_cg_poisson_f32_dia_matches_reference():
    lap = poisson2d(32, np.float32)
    b = np.ones(lap.shape[0], np.float32)
    x, info = solvers.cg(tsm.CSR.from_scipy(lap).to_dia(), torch.from_numpy(b),
                         tol=0.0, rtol=1e-5)
    jx, jinfo = jsolvers.cg(jsm.CSR.from_scipy(lap).to_dia(), jnp.asarray(b),
                            tol=0.0, rtol=1e-5)
    assert x.dtype == torch.float32 and bool(info.converged)
    assert abs(int(info.iterations) - int(jinfo.iterations)) <= 1
    assert rel(x, jx) < 1e-5


@pytest.mark.parametrize("maxiter", [1, 7, 20])
def test_cg_maxiter_and_history_match_reference(maxiter):
    """maxiter stops unconverged runs with converged=False, and the history
    holds one ‖r‖ per executed iteration, padded with -1."""
    lap = poisson2d(16)
    b = np.ones(lap.shape[0])
    x, info = solvers.cg(tsm.CSR.from_scipy(lap), torch.from_numpy(b), tol=1e-10,
                         maxiter=maxiter, record_history=True)
    jx, jinfo = jsolvers.cg(jsm.CSR.from_scipy(lap), jnp.asarray(b), tol=1e-10,
                            maxiter=maxiter, record_history=True)
    assert int(info.iterations) == int(jinfo.iterations) == maxiter
    assert not bool(info.converged) and not bool(jinfo.converged)
    assert info.residual_history.shape == (maxiter,)
    np.testing.assert_allclose(info.residual_history.numpy(),
                               np.asarray(jinfo.residual_history), rtol=1e-9)
    assert rel(x, jx) < 1e-9


def test_cg_history_pads_after_convergence():
    lap = poisson2d(8)
    b = torch.ones(lap.shape[0], dtype=torch.float64)
    _, info = solvers.cg(tsm.CSR.from_scipy(lap), b, tol=1e-6, maxiter=100,
                         record_history=True)
    k = int(info.iterations)
    assert bool(info.converged) and 0 < k < 100
    h = info.residual_history.numpy()
    assert (h[:k] > 0).all() and (h[k:] == -1).all()
    assert h[k - 1] == pytest.approx(float(info.residual_norm))
    # maxiter=0 runs nothing (the reference raises here: it indexes an
    # empty history)
    x, info = solvers.cg(tsm.CSR.from_scipy(lap), b, maxiter=0, record_history=True)
    assert int(info.iterations) == 0 and info.residual_history.shape == (0,)
    assert not x.any()


def test_cg_callable_matvec_preconditioner_and_x0():
    lap = poisson2d(8)
    dense = torch.from_numpy(lap.toarray())
    b = torch.ones(lap.shape[0], dtype=torch.float64)
    x, info = solvers.cg(lambda v: dense @ v, b, tol=1e-10)
    np.testing.assert_allclose((dense @ x).numpy(), b.numpy(), atol=1e-8)
    dinv = 1.0 / torch.diagonal(dense)
    xp, pinfo = solvers.cg(tsm.CSR.from_scipy(lap), b, tol=1e-10, M=lambda r: dinv * r)
    jxp, jpinfo = jsolvers.cg(jsm.CSR.from_scipy(lap), jnp.asarray(b.numpy()), tol=1e-10,
                              M=lambda r: jnp.asarray(dinv.numpy()) * r)
    assert int(pinfo.iterations) == int(jpinfo.iterations)
    assert rel(xp, jxp) < 1e-9
    x0 = x.clone()
    _, info0 = solvers.cg(tsm.CSR.from_scipy(lap), b, x0, tol=1e-8)
    assert int(info0.iterations) == 0 and bool(info0.converged)


def test_cg_operand_checks():
    A = tsm.CSR.from_scipy(poisson2d(4))
    with pytest.raises(TypeError, match="float"):
        solvers.cg(A, torch.ones(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="dimension"):
        solvers.cg(A, torch.ones(15, dtype=torch.float64))
    rect = tsm.CSR.from_scipy(sp.csr_matrix(np.ones((2, 3))))
    with pytest.raises(ValueError, match="square"):
        solvers.cg(rect, torch.ones(2, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_slice_end_to_end_matches_reference(dtype):
    """SparseBuilder.add_batch → to_csr → to_dia → cg in both packages on
    the same 24² Poisson system."""
    n = 24
    m = n * n
    lap = poisson2d(n).tocoo()
    order = np.random.default_rng(3).permutation(lap.nnz)   # unsorted input
    r, c, v = lap.row[order], lap.col[order], lap.data[order]
    b = np.random.default_rng(4).standard_normal(m).astype(dtype)
    tol = {np.float32: 0.0, np.float64: 1e-10}[dtype]
    rtol = {np.float32: 1e-5, np.float64: 0.0}[dtype]

    tb = tsm.SparseBuilder(dtype=dtype)
    tb.add_batch(r, c, v)
    tdia = tb.to_csr().to_dia()
    jb = jsm.SparseBuilder(dtype=dtype)
    jb.add_batch(r, c, v)
    jdia = jb.to_csr().to_dia()
    assert tdia.offsets == tuple(jdia.offsets) == (-n, -1, 0, 1, n)
    np.testing.assert_array_equal(tdia.data.numpy(), np.asarray(jdia.data))

    x, info = solvers.cg(tdia, torch.from_numpy(b), tol=tol, rtol=rtol)
    jx, jinfo = jsolvers.cg(jdia, jnp.asarray(b), tol=tol, rtol=rtol)
    assert bool(info.converged) and bool(jinfo.converged)
    assert abs(int(info.iterations) - int(jinfo.iterations)) <= 1
    assert x.dtype == torch.from_numpy(b).dtype
    assert rel(x, jx) < {np.float32: 1e-5, np.float64: 1e-9}[dtype]
    np.testing.assert_allclose(lap @ x.numpy().astype(np.float64), b,
                               atol={np.float32: 1e-3, np.float64: 1e-8}[dtype])
