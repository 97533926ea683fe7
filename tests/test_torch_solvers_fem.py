"""The port's solvers and preconditioners beyond CG against
``sparsemat_tpu.solvers`` on the same seeded systems, through DIA, CSR and
StripELL; the FEM slice at a small size (matgen → StripELL → PCG) in both
packages; and the port's copy of ``matgen`` against the original.

Tolerances: in f64 the iteration counts are equal and x agrees to 1e-10
relative to max|x_ref| (the two run the same arithmetic in other summation
orders).  In f32 the counts may differ by one (the last residual can cross
the threshold one step apart) and x agrees to 1e-4.  Refinement histories:
the first entry (‖b‖) to 1e-12; later entries come out of f32 inner solves
and agree to 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sparsemat_tpu as jsm
from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu import matgen as jmatgen
from sparsemat_tpu import solvers as js
from sparsemat_tpu_torch import matgen
from sparsemat_tpu_torch import solvers as ts


def dominant(m, skew=0.0):
    """``m`` with its diagonal set to Σ_j≠i |a_ij| + 1 (symmetric m → SPD);
    ``skew`` adds +skew at (i, i+1) and −skew at (i+1, i)."""
    m = sp.csr_matrix(m, dtype=np.float64)
    m.setdiag(0)
    m.eliminate_zeros()
    d = np.asarray(abs(m).sum(1)).ravel() + 1.0
    out = m + sp.diags(d)
    if skew:
        n = m.shape[0]
        out = out + sp.diags([skew * np.ones(n - 1), -skew * np.ones(n - 1)], [1, -1])
    out = out.tocsr()
    out.sort_indices()
    return out


def system(skew=0.0, n=300, seed=0):
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, 0.05, random_state=rng, format="csr")
    m = sp.tril(sp.triu(m + m.T, -20), 20)
    return dominant(m, skew)


def freeze(pkg, m, fmt):
    csr = pkg.CSR.from_scipy(m)
    return {"csr": csr, "dia": csr.to_dia(), "strip": csr.to_strip()}[fmt]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def run(pkg, solvers, A, b, name, m):
    """One solver call of either package, by name."""
    if name == "pcg_jacobi":
        return solvers.cg(A, b, tol=1e-10, M=solvers.JacobiPreconditioner.from_matrix(A))
    if name == "pcg_block_jacobi":
        M = solvers.BlockJacobiPreconditioner.from_matrix(A, block_size=16)
        return solvers.cg(A, b, tol=1e-10, M=M)
    if name in ("bicgstab", "bicgstab_ns"):
        return solvers.bicgstab(A, b, tol=1e-10)
    if name == "bicgstab_jacobi":
        return solvers.bicgstab(A, b, tol=1e-10,
                                M=solvers.JacobiPreconditioner.from_matrix(A))
    if name in ("gmres", "gmres_ns"):
        return solvers.gmres(A, b, tol=1e-10, restart=10)
    if name == "chebyshev":
        lam = 2.0 * float(m.diagonal().max()) - 1.0     # Gershgorin
        return solvers.chebyshev(A, b, tol=1e-8, lambda_min=1.0, lambda_max=lam)
    if name == "jacobi":
        return solvers.jacobi(A, b, tol=1e-10)
    if name == "jacobi_weighted":
        return solvers.jacobi(A, b, tol=1e-10, omega=0.8)
    raise ValueError(name)


SOLVERS = ["pcg_jacobi", "pcg_block_jacobi", "bicgstab", "bicgstab_jacobi", "gmres",
           "chebyshev", "jacobi", "jacobi_weighted", "bicgstab_ns", "gmres_ns"]


@pytest.mark.parametrize("fmt", ["csr", "dia", "strip"])
@pytest.mark.parametrize("name", SOLVERS)
def test_solver_f64_matches_reference(name, fmt):
    m = system(skew=0.4 if name.endswith("_ns") else 0.0)
    b = np.random.default_rng(1).standard_normal(m.shape[0])
    jx, jinfo = run(jsm, js, freeze(jsm, m, fmt), jnp.asarray(b), name, m)
    x, info = run(tsm, ts, freeze(tsm, m, fmt), torch.from_numpy(b), name, m)
    assert bool(info.converged) and bool(jinfo.converged)
    assert int(info.iterations) == int(jinfo.iterations) > 0
    assert x.dtype == torch.float64
    assert rel(x, jx) < 1e-10
    assert float(info.residual_norm) == pytest.approx(float(jinfo.residual_norm), rel=1e-6)


@pytest.mark.parametrize("name", ["pcg_jacobi", "bicgstab", "gmres", "jacobi"])
def test_solver_f32_dia_matches_reference(name):
    m = system().astype(np.float32)
    b = np.random.default_rng(2).standard_normal(m.shape[0]).astype(np.float32)
    # f32: stop at a relative 1e-5 instead of the f64 1e-10
    tol_b = 1e-5 * float(np.linalg.norm(b))
    jx, jinfo = {"pcg_jacobi": lambda A: js.cg(A, jnp.asarray(b), tol=tol_b,
                                               M=js.JacobiPreconditioner.from_matrix(A)),
                 "bicgstab": lambda A: js.bicgstab(A, jnp.asarray(b), tol=tol_b),
                 "gmres": lambda A: js.gmres(A, jnp.asarray(b), tol=tol_b, restart=10),
                 "jacobi": lambda A: js.jacobi(A, jnp.asarray(b), tol=tol_b)}[name](
        freeze(jsm, m, "dia"))
    A = freeze(tsm, m, "dia")
    tb = torch.from_numpy(b)
    x, info = {"pcg_jacobi": lambda: ts.cg(A, tb, tol=tol_b,
                                           M=ts.JacobiPreconditioner.from_matrix(A)),
               "bicgstab": lambda: ts.bicgstab(A, tb, tol=tol_b),
               "gmres": lambda: ts.gmres(A, tb, tol=tol_b, restart=10),
               "jacobi": lambda: ts.jacobi(A, tb, tol=tol_b)}[name]()
    assert x.dtype == torch.float32 and bool(info.converged) and bool(jinfo.converged)
    assert abs(int(info.iterations) - int(jinfo.iterations)) <= 1
    assert rel(x, jx) < 1e-4


@pytest.mark.parametrize("maxiter", [0, 3, 25])
def test_maxiter_stops_unconverged_as_reference(maxiter):
    m = system()
    b = np.random.default_rng(3).standard_normal(m.shape[0])
    A, jA = tsm.CSR.from_scipy(m), jsm.CSR.from_scipy(m)
    for tfn, jfn, kw in ((ts.bicgstab, js.bicgstab, {}), (ts.jacobi, js.jacobi, {}),
                         (ts.gmres, js.gmres, {"restart": 10}),
                         (ts.chebyshev, js.chebyshev, {"lambda_min": 1.0, "lambda_max": 40.0})):
        x, info = tfn(A, torch.from_numpy(b), tol=1e-30, maxiter=maxiter, **kw)
        jx, jinfo = jfn(jA, jnp.asarray(b), tol=1e-30, maxiter=maxiter, **kw)
        assert int(info.iterations) == int(jinfo.iterations), tfn.__name__
        assert not bool(info.converged) and not bool(jinfo.converged)
        assert rel(x, jx) < 1e-10 if np.abs(np.asarray(jx)).max() else not x.any()


# -- preconditioners ------------------------------------------------------------

def test_jacobi_preconditioner_and_diagonals_equal_reference():
    m = system().tolil()
    m[5, 5] = 0.0                               # a zero on the diagonal
    m = m.tocsr()
    for fmt in ("csr", "dia", "strip"):
        jM = js.JacobiPreconditioner.from_matrix(freeze(jsm, m, fmt))
        tM = ts.JacobiPreconditioner.from_matrix(freeze(tsm, m, fmt))
        np.testing.assert_array_equal(tM.dinv.numpy(), np.asarray(jM.dinv))
    np.testing.assert_array_equal(tsm.CSR.from_scipy(m).to_dia().diagonal().numpy(),
                                  np.asarray(jsm.CSR.from_scipy(m).to_dia().diagonal()))
    jc, tc = jsm.CSR.from_scipy(m), tsm.CSR.from_scipy(m)
    np.testing.assert_array_equal(tc.row_nnz().numpy(), np.asarray(jc.row_nnz()))
    assert tc.max_row_nnz() == jc.max_row_nnz()
    assert tsm.DIA.diagonal_count(tc) == jsm.DIA.diagonal_count(jc)
    off = tsm.DIA.from_csr(tsm.CSR.from_scipy(sp.diags([np.ones(9)], [1], shape=(10, 10))))
    assert not off.diagonal().any()


@pytest.mark.parametrize("n,bs", [(300, 16), (301, 64)])
def test_block_jacobi_preconditioner_equals_reference(n, bs):
    m = system(n=n).tolil()
    m[7, :] = 0.0                               # an empty row: unit pivot
    m[:, 7] = 0.0
    m = m.tocsr()
    m.eliminate_zeros()
    jM = js.BlockJacobiPreconditioner.from_matrix(jsm.CSR.from_scipy(m), bs)
    tM = ts.BlockJacobiPreconditioner.from_matrix(tsm.CSR.from_scipy(m), bs)
    assert tM.n == jM.n == n
    assert rel(tM.blocks_inv, jM.blocks_inv) < 1e-12
    r = np.random.default_rng(4).standard_normal(n)
    assert rel(tM.apply(torch.from_numpy(r)), jM.apply(jnp.asarray(r))) < 1e-12


# -- refinement -----------------------------------------------------------------

def test_refine_history_matches_reference_and_passes_f32_stagnation():
    m = system(n=400)
    b = np.random.default_rng(5).standard_normal(400)
    jx, jinfo = js.refine(jsm.CSR.from_scipy(m), jnp.asarray(b), tol=1e-11)
    x, info = ts.refine(tsm.CSR.from_scipy(m), torch.from_numpy(b), tol=1e-11)
    hist, jhist = info.residual_history.numpy(), np.asarray(jinfo.residual_history)
    assert hist.shape == jhist.shape and hist.shape[0] > 2
    assert hist[0] == pytest.approx(jhist[0], rel=1e-12)
    np.testing.assert_allclose(hist, jhist, rtol=1e-3)
    assert bool(info.converged) and float(info.residual_norm) < 1e-11
    assert abs(int(info.iterations) - int(jinfo.iterations)) <= hist.shape[0]
    assert rel(x, jx) < 1e-10


def test_refine_on_strip_casts_its_own_low_operator():
    """The JAX package's ``StripELL.astype`` fails on the parts tuple, so its
    side gets ``A_low`` explicitly; the port casts the parts itself."""
    m = system(n=400)
    b = np.random.default_rng(6).standard_normal(400)
    jA_low = jsm.CSR.from_scipy(m.astype(np.float32)).to_strip()
    with pytest.raises(AttributeError):
        jsm.CSR.from_scipy(m).to_strip().astype(jnp.float32)
    jx, jinfo = js.refine(jsm.CSR.from_scipy(m).to_strip(), jnp.asarray(b), tol=1e-11,
                          A_low=jA_low)
    x, info = ts.refine(tsm.CSR.from_scipy(m).to_strip(), torch.from_numpy(b), tol=1e-11)
    np.testing.assert_allclose(info.residual_history.numpy(),
                               np.asarray(jinfo.residual_history), rtol=1e-3)
    assert bool(info.converged) and rel(x, jx) < 1e-10


def test_refine_host_history_matches_reference():
    m = system(n=400)
    b = np.random.default_rng(7).standard_normal(400)
    jx, jinfo = js.refine_host(m, b, tol=1e-11,
                               A_low=jsm.CSR.from_scipy(m.astype(np.float32)))
    x, info = ts.refine_host(m, b, tol=1e-11,
                             A_low=tsm.CSR.from_scipy(m.astype(np.float32)))
    assert isinstance(x, np.ndarray) and x.dtype == np.float64
    assert info.residual_norm.dtype == torch.float32
    np.testing.assert_allclose(info.residual_history.numpy(),
                               np.asarray(jinfo.residual_history), rtol=1e-3)
    assert bool(info.converged) and rel(x, jx) < 1e-10
    with pytest.raises(ValueError, match="A_low"):
        ts.refine_host(m, b)


# -- class wrappers, operand checks ------------------------------------------------

@pytest.mark.parametrize("cls", ["Jacobi", "BiCGStab", "GMRES"])
def test_class_wrappers_match_reference_defaults(cls):
    tobj, jobj = getattr(ts, cls)(), getattr(js, cls)()
    assert vars(tobj) == vars(jobj)
    assert getattr(tsm, cls) is getattr(ts, cls)
    m = system(skew=0.4 if cls != "Jacobi" else 0.0, n=100)
    b = np.random.default_rng(8).standard_normal(100)
    x, info = tobj.solve(tsm.CSR.from_scipy(m), torch.from_numpy(b))
    jx, jinfo = jobj.solve(jsm.CSR.from_scipy(m), jnp.asarray(b))
    assert int(info.iterations) == int(jinfo.iterations)
    assert rel(x, jx) < 1e-10


def test_solver_operand_checks():
    with pytest.raises(TypeError, match="diagonal"):
        ts.jacobi(lambda v: v, torch.ones(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float"):
        ts.bicgstab(tsm.CSR.from_scipy(system(n=10)), torch.ones(10, dtype=torch.int64))
    with pytest.raises(ValueError, match="square"):
        ts.gmres(tsm.CSR.from_scipy(sp.csr_matrix(np.ones((2, 3)))),
                 torch.ones(2, dtype=torch.float64))


# -- the FEM slice at a small size -------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fem_strip_pcg_matches_reference(dtype):
    """fem_block_band → SparseBuilder → CSR → StripELL → PCG(Jacobi) in both
    packages on the same dominant-diagonal FEM system."""
    m = dominant(matgen.fem_block_band(n_nodes=2000, bandwidth=60, seed=3)).astype(dtype)
    coo = m.tocoo()
    b = np.random.default_rng(9).standard_normal(m.shape[0]).astype(dtype)
    sts = []
    for pkg in (tsm, jsm):
        builder = pkg.SparseBuilder(dtype=dtype)
        builder.add_batch(coo.row, coo.col, coo.data)
        sts.append(builder.to_csr().to_strip())
    tst, jst = sts
    for tp, jp in zip(tst.parts, jst.parts):
        np.testing.assert_array_equal(tp.vals.numpy(), np.asarray(jp.vals))
    rtol = {np.float32: 1e-5, np.float64: 1e-10}[dtype]
    x, info = ts.cg(tst, torch.from_numpy(b), tol=0.0, rtol=rtol,
                    M=ts.JacobiPreconditioner.from_matrix(tst))
    jx, jinfo = js.cg(jst, jnp.asarray(b), tol=0.0, rtol=rtol,
                      M=js.JacobiPreconditioner.from_matrix(jst))
    assert bool(info.converged) and bool(jinfo.converged)
    assert x.dtype == torch.from_numpy(b).dtype
    if dtype == np.float64:
        assert int(info.iterations) == int(jinfo.iterations)
        assert rel(x, jx) < 1e-10
    else:
        assert abs(int(info.iterations) - int(jinfo.iterations)) <= 1
        assert rel(x, jx) < 1e-4
    r = b.astype(np.float64) - m.astype(np.float64) @ x.numpy().astype(np.float64)
    assert np.linalg.norm(r) <= 1e-4 * np.linalg.norm(b)


# -- matgen ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matgen_copies_equal_the_originals(seed):
    for fn, kw in (("fem_block_band", dict(n_nodes=700, bandwidth=50)),
                   ("circuit_scatter", dict(n=3000)),
                   ("fem_stiffness_p1", dict(nx=6 + seed, ny=5))):
        if fn != "fem_stiffness_p1":
            kw = dict(kw, seed=seed)
        got, want = getattr(matgen, fn)(**kw), getattr(jmatgen, fn)(**kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
