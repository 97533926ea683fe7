"""The port's SOR / Gauss–Seidel against the JAX package's on the same
inputs: 6² Poisson (Gauss–Seidel, and SOR at ω = 1.5 beating it), an
unsymmetric-pattern matrix whose level schedule puts a row that another
row reads old into an earlier level than the reader, f32 and f64.
Iteration counts are equal; iterates agree within 1e-5 (f32) and 1e-10
(f64) of max |x|, since the port sums each row in CSR order where the
reference sums its ELL slots.  One level-scheduled sweep is held to a
row-by-row sweep in f64 numpy to 1e-12.

The port's sweep reads a buffer of [new x | old x]: the gather takes the
new x_j for j < i and the old x_j for every other column, so a row's
anti-dependency on a row of an earlier level is kept without symmetrising
the pattern (``test_anti_dependency_reads_the_old_value`` shows the
schedule that needs it).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import LazyModule, port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import solvers

jnp = LazyModule("jax.numpy")
jsm = LazyModule("sparsemat_tpu")

TOL = {np.float32: 1e-5, np.float64: 1e-10}


def poisson2d(n, dtype=np.float64):
    main = 4.0 * np.ones(n * n)
    off = -np.ones(n * n - 1)
    off[np.arange(1, n * n) % n == 0] = 0.0
    far = -np.ones(n * n - n)
    return sp.diags([main, off, off, far, far], [0, 1, -1, n, -n], format="csr",
                    dtype=dtype)


def unsymmetric(n=60, seed=2, dtype=np.float64):
    """Diagonally dominant with an unsymmetric pattern: random entries, each
    kept on one side of the diagonal only, and a few rows with no entry left
    of the diagonal (so they land in level 0 ahead of rows that read them)."""
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, 0.08, format="coo", random_state=rng, dtype=np.float64)
    keep = (m.row < m.col) | (rng.random(m.nnz) < 0.5)
    off = sp.coo_matrix((m.data[keep] - 0.5, (m.row[keep], m.col[keep])), shape=(n, n)).tocsr()
    off = off - sp.diags(off.diagonal())
    lower = sp.tril(off, -1).tolil()
    lower[n - 3:, :] = 0                   # rows n-3.. read nothing new
    off = (lower + sp.triu(off, 1)).tocsr()
    d = np.abs(off).sum(axis=1).A.ravel() + 1.0
    return (off + sp.diags(d)).tocsr().astype(dtype)


def row_sweep(m, b, x, omega):
    """One SOR sweep, row by row in f64: the reference's update."""
    m = m.tocsr().astype(np.float64)
    x = np.array(x, np.float64)
    diag = m.diagonal()
    for i in range(m.shape[0]):
        lo, hi = m.indptr[i], m.indptr[i + 1]
        s = float(m.data[lo:hi] @ x[m.indices[lo:hi]]) - diag[i] * x[i]
        dinv = 1.0 / diag[i] if diag[i] != 0 else 0.0
        x[i] = (1 - omega) * x[i] + omega * dinv * (b[i] - s)
    return x


def solve_both(m, b, dt, **kw):
    jA, tA = jsm.CSR.from_scipy(m.astype(dt)), tsm.CSR.from_scipy(m.astype(dt))
    jx, ji = jsm.solvers.sor(jA, jnp.asarray(b.astype(dt)), **kw)
    tx, ti = solvers.sor(tA, torch.from_numpy(b.astype(dt)), **kw)
    return (np.asarray(jx), ji), (tx, ti)


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("omega", [1.0, 1.5])
def test_poisson_matches_reference(omega, dt):
    m = poisson2d(6)
    tol = 1e-9 if dt == np.float64 else 1e-5
    (jx, ji), (tx, ti) = solve_both(m, np.ones(36), dt, tol=tol, maxiter=2000, omega=omega)
    assert int(ti.iterations) == int(ji.iterations)
    assert bool(ti.converged) == bool(ji.converged) is True
    assert tx.dtype == torch.from_numpy(np.zeros(0, dt)).dtype
    assert np.abs(tx.numpy() - jx).max() <= TOL[dt] * np.abs(jx).max()
    np.testing.assert_allclose(m @ tx.numpy().astype(np.float64), 1.0, atol=1e-4)


def test_sor_beats_gauss_seidel_as_reference():
    A = tsm.CSR.from_scipy(poisson2d(6))
    b = torch.ones(36, dtype=torch.float64)
    _, gs = solvers.gauss_seidel(A, b, tol=1e-9, maxiter=2000)
    _, so = solvers.sor(A, b, tol=1e-9, maxiter=2000, omega=1.5)
    jA = jsm.CSR.from_scipy(poisson2d(6))
    _, jgs = jsm.solvers.gauss_seidel(jA, jnp.ones(36), tol=1e-9, maxiter=2000)
    assert int(so.iterations) < int(gs.iterations) == int(jgs.iterations)


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("omega", [1.0, 1.3])
def test_unsymmetric_pattern_matches_reference(omega, dt):
    m = unsymmetric()
    b = np.random.default_rng(4).standard_normal(60)
    tol = 1e-10 if dt == np.float64 else 1e-4
    (jx, ji), (tx, ti) = solve_both(m, b, dt, tol=tol, maxiter=500, omega=omega)
    assert int(ti.iterations) == int(ji.iterations) > 3
    assert np.abs(tx.numpy() - jx).max() <= TOL[dt] * np.abs(jx).max()


def test_anti_dependency_reads_the_old_value():
    """Row 1 reads x_2 old (a_12 ≠ 0) and row 2 reads nothing new, so the
    schedule puts row 2 in level 0, before row 1: a single x buffer would
    hand row 1 the new x_2."""
    m = sp.csr_matrix(np.array([[4.0, 0.0, 0.0],
                                [1.0, 5.0, 2.0],
                                [0.0, 0.0, 3.0]]))
    A = tsm.CSR.from_scipy(m)
    sched = solvers.sor_schedule(A)
    assert sched.n_levels == 2
    assert sched.perm.tolist() == [0, 2, 1]        # levels [0, 2] and [1]
    b = np.array([1.0, 2.0, 3.0])
    x0 = np.array([0.5, -1.0, 7.0])
    x, _ = solvers.sor(A, torch.from_numpy(b), torch.from_numpy(x0), maxiter=1, omega=1.2)
    np.testing.assert_allclose(x.numpy(), row_sweep(m, b, x0, 1.2), rtol=0, atol=1e-15)
    jx, _ = jsm.solvers.sor(jsm.CSR.from_scipy(m), jnp.asarray(b), jnp.asarray(x0),
                            maxiter=1, omega=1.2)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-15)


@pytest.mark.parametrize("case", ["poisson", "unsymmetric"])
def test_one_sweep_equals_a_row_by_row_sweep(case):
    m = poisson2d(9) if case == "poisson" else unsymmetric(120, seed=5)
    n = m.shape[0]
    rng = np.random.default_rng(6)
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    A = tsm.CSR.from_scipy(m)
    for omega in (1.0, 1.7):
        x, info = solvers.sor(A, torch.from_numpy(b), torch.from_numpy(x0), maxiter=1,
                              omega=omega)
        assert int(info.iterations) == 1
        want = row_sweep(m, b, x0, omega)
        assert np.abs(x.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_levels_order_every_lower_dependency():
    m = unsymmetric(200, seed=9)
    levels = solvers.sor_levels(m.indptr, m.indices)
    level = np.empty(200, np.int64)
    for k, rows in enumerate(levels):
        assert np.all(np.diff(rows) > 0)
        level[rows] = k
    assert sorted(np.concatenate(levels).tolist()) == list(range(200))
    coo = m.tocoo()
    low = coo.col < coo.row
    assert np.all(level[coo.col[low]] < level[coo.row[low]])
    # each row of level k > 0 waits on some row of level k - 1
    for k in range(1, len(levels)):
        for r in levels[k]:
            deps = coo.col[low & (coo.row == r)]
            assert level[deps].max() == k - 1


def test_schedule_is_cached_and_gauss_seidel_is_omega_one():
    A = tsm.CSR.from_scipy(poisson2d(5))
    assert solvers.sor_schedule(A) is solvers.sor_schedule(A)
    assert solvers.sor_schedule(A).n_levels == 9          # 2n − 1 anti-diagonals
    b = torch.ones(25, dtype=torch.float64)
    x1, i1 = solvers.gauss_seidel(A, b, tol=1e-8)
    x2, i2 = solvers.sor(A, b, tol=1e-8, omega=1.0)
    assert torch.equal(x1, x2) and int(i1.iterations) == int(i2.iterations)


def test_sor_refuses_what_the_reference_cannot_sweep():
    A = tsm.CSR.from_scipy(sp.random(4, 5, 0.5, format="csr", random_state=0))
    with pytest.raises(ValueError, match="dimension|square"):
        solvers.sor(A, torch.ones(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="sparse format"):
        solvers.sor(lambda v: v, torch.ones(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float"):
        solvers.sor(tsm.CSR.from_scipy(poisson2d(2)), torch.ones(4, dtype=torch.int32))


# -- on the card (needs a card) ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cuda_sor_matches_the_cpu_path_and_reruns_bitwise(cuda, dt):
    m = poisson2d(16)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(256)).to(dt)
    tol = 1e-5 if dt == torch.float32 else 1e-10
    xc, ic = solvers.sor(tsm.CSR.from_scipy(m, device="cpu"), b, rtol=tol, omega=1.5)
    G = tsm.CSR.from_scipy(m, device=cuda)
    xg, ig = solvers.sor(G, b.to(cuda), rtol=tol, omega=1.5)
    assert int(ig.iterations) == int(ic.iterations)
    assert float((xg.cpu() - xc).abs().max()) <= (1e-5 if dt == torch.float32 else 1e-10) \
        * float(xc.abs().max())
    xg2, ig2 = solvers.sor(G, b.to(cuda), rtol=tol, omega=1.5)
    assert torch.equal(xg2, xg) and int(ig2.iterations) == int(ig.iterations)
