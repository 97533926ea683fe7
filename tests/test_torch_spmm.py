"""The port's ``spmm`` dispatch, the new ``spmv`` branches, ``A @ B``, the
ELL format, checkpoints and ``from_reference`` of the four new formats
(BSR, ELL, SlabELL, SlabPack), and the SpMM slice end to end, all against
``sparsemat_tpu`` on the same seeded inputs.

Tolerances: relative to max|reference|, 1e-5 in f32 and 1e-12 in f64 (the
same sums in other orders).  The f64 BiCGStab solve: iteration counts
within one (the last residual may cross the threshold a step apart) and x
to 1e-8.  f32 operands are passed explicitly,
because ``tests/conftest.py`` turns on JAX's x64 mode.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import plan_launches
from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import checkpoint as tck
from sparsemat_tpu_torch import matgen
from sparsemat_tpu_torch.interop import from_reference
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.ops import matvec as tmv
from sparsemat_tpu_torch.utils import profiling

NEW_FORMATS = ["bsr", "ell", "slab", "slab_pack"]


def banded(n=300, seed=0, skew_rows=False):
    """Random entries within 60 of the diagonal plus a diagonal;
    ``skew_rows`` gives a few rows 120 entries, so ELL pads too much and
    ``spmm`` of a CSR takes the stream path."""
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, 0.04, random_state=rng, format="coo", dtype=np.float64)
    keep = np.abs(m.row - m.col) <= 60
    m = sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=(n, n)).tocsr()
    m = m + sp.eye(n, format="csr")
    if skew_rows:
        m = m.tolil()
        for r in (3, 150):
            m[r, rng.choice(n, 120, replace=False)] = rng.standard_normal(120)
    m = sp.csr_matrix(m)
    m.sort_indices()
    return m


def jax_ref():
    """The JAX package, jax.numpy, its checkpoint module and its ops
    module (imported here, so this file's CUDA tests run without JAX)."""
    jsm = pytest.importorskip("sparsemat_tpu")
    import jax.numpy as jnp
    from sparsemat_tpu import checkpoint as jck
    from sparsemat_tpu.ops import matvec as jmv

    return jsm, jnp, jck, jmv


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def freeze(pkg, m, fmt):
    csr = pkg.CSR.from_scipy(m)
    if fmt == "bsr":
        return pkg.BSR.from_csr(csr)
    if fmt == "coo":
        return csr.to_coo()
    return csr if fmt == "csr" else getattr(csr, f"to_{fmt}")()


TOL = {np.float32: 1e-5, np.float64: 1e-12}


# -- spmm against sparsemat_tpu.spmm ------------------------------------------------

@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr", "dia", "ell", "slab", "slab_pack"])
def test_spmm_by_format_matches_reference(fmt, dt):
    jsm, jnp, jck, jmv = jax_ref()
    m = banded().astype(dt)
    B = np.random.default_rng(1).standard_normal((300, 11)).astype(dt)
    want = jsm.spmm(freeze(jsm, m, fmt), jnp.asarray(B))
    got = tsm.spmm(freeze(tsm, m, fmt), torch.from_numpy(B))
    assert got.dtype == torch.from_numpy(B).dtype and got.shape == (300, 11)
    assert rel_err(got, want) < TOL[dt]
    assert rel_err(got, m @ B) < TOL[dt]


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("method", [None, "pallas", "bsr", "dia", "slab_pack", "slab", "ell"])
def test_spmm_methods_match_reference(method, dt):
    jsm, jnp, jck, jmv = jax_ref()
    m = banded(seed=2).astype(dt)
    B = np.random.default_rng(3).standard_normal((300, 6)).astype(dt)
    want = jsm.spmm(jsm.CSR.from_scipy(m), jnp.asarray(B), method=method)
    got = tsm.spmm(tsm.CSR.from_scipy(m), torch.from_numpy(B), method=method)
    assert rel_err(got, want) < TOL[dt]


def test_spmm_gell_and_unknown_methods_raise():
    csr = tsm.CSR.from_scipy(banded())
    B = torch.zeros(300, 2)
    for method in ("stream", "nope"):
        with pytest.raises(ValueError, match="unknown method"):
            tsm.spmm(csr, B, method=method)
    # 'gell', ported since, computes
    Bg = torch.from_numpy(np.random.default_rng(4).standard_normal((300, 2)).astype(np.float32))
    assert rel_err(tsm.spmm(csr, Bg, method="gell"), banded() @ Bg.numpy()) < 1e-5
    with pytest.raises(ValueError, match="dimension"):
        tsm.spmm(csr, torch.zeros(299, 2))


@pytest.mark.parametrize("skew_rows", [False, True], ids=["ell", "stream"])
def test_csr_spmm_takes_the_ell_or_stream_path_as_reference(skew_rows, monkeypatch):
    jsm, jnp, jck, jmv = jax_ref()
    m = banded(seed=4, skew_rows=skew_rows).astype(np.float32)
    taken = {"jax": [], "torch": []}
    for mod, key in ((jmv, "jax"), (tmv, "torch")):
        for fn in ("_ell_spmm", "_stream_spmm_tiled"):
            orig = getattr(mod, fn)
            monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _f=fn, _k=key:
                                taken[_k].append(_f) or _o(*a))
    B = np.random.default_rng(5).standard_normal((300, 4)).astype(np.float32)
    want = jsm.spmm(jsm.CSR.from_scipy(m), jnp.asarray(B))
    got = tsm.spmm(tsm.CSR.from_scipy(m), torch.from_numpy(B))
    assert taken["torch"] == taken["jax"] == ["_stream_spmm_tiled" if skew_rows else "_ell_spmm"]
    assert rel_err(got, want) < 1e-5


def test_stream_spmm_tiles_columns_within_the_budget(monkeypatch):
    m = banded(seed=6, skew_rows=True)
    csr = tsm.CSR.from_scipy(m)
    B = torch.from_numpy(np.random.default_rng(7).standard_normal((300, 10)))
    whole = tsm.spmm(csr, B)
    monkeypatch.setattr(tmv, "_SPMM_GATHER_BUDGET", csr.nse * 8 * 3)   # 3 columns a tile
    tiled = tsm.spmm(csr, B)
    assert torch.equal(tiled, whole) and torch.equal(tsm.spmm(csr, B), tiled)
    assert rel_err(tiled, m @ B.numpy()) < 1e-12


def test_matmul_with_a_rank_2_operand():
    jsm, jnp, jck, jmv = jax_ref()
    m = banded(seed=8).astype(np.float32)
    B = np.random.default_rng(9).standard_normal((300, 5)).astype(np.float32)
    for fmt in ("csr", "bsr", "slab_pack"):
        mat = freeze(tsm, m, fmt)
        assert torch.equal(mat @ torch.from_numpy(B), tsm.spmm(mat, torch.from_numpy(B)))
        assert rel_err(mat @ B, jsm.CSR.from_scipy(m) @ jnp.asarray(B)) < 1e-5
    csr = tsm.CSR.from_scipy(m)
    prod = csr @ csr                              # sparse @ sparse is SpGEMM
    assert torch.equal(prod.data, tsm.spgemm(csr, csr).data)
    assert rel_err(prod.todense(), (m @ m).toarray()) < 1e-5
    with pytest.raises(ValueError, match="rank 3"):
        csr @ torch.zeros(300, 2, 2)


def test_spmm_of_no_columns_and_of_an_empty_matrix():
    e = sp.csr_matrix((40, 30), dtype=np.float32)
    for fmt in ("csr", "bsr", "ell", "slab", "slab_pack"):
        mat = freeze(tsm, e, fmt)
        assert torch.equal(tsm.spmm(mat, torch.ones(30, 3)), torch.zeros(40, 3)), fmt
        assert tsm.spmm(freeze(tsm, banded(), fmt), torch.ones(300, 0)).shape == (300, 0)


# -- the new spmv branches ---------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["bsr", "ell", "slab", "slab_pack"])
def test_spmv_of_the_new_formats_matches_reference(fmt):
    jsm, jnp, jck, jmv = jax_ref()
    m = banded(seed=10).astype(np.float32)
    x = np.random.default_rng(11).standard_normal(300).astype(np.float32)
    jmat, tmat = freeze(jsm, m, fmt), freeze(tsm, m, fmt)
    want = jsm.spmv(jmat, jnp.asarray(x))
    got = tsm.spmv(tmat, torch.from_numpy(x))
    assert rel_err(got, want) < 1e-5
    assert torch.equal(tmat @ torch.from_numpy(x), got)
    y, d = tsm.spmv_dot(tmat, torch.from_numpy(x))
    jy, jd = jsm.spmv_dot(jmat, jnp.asarray(x))
    assert torch.equal(y, got) and float(d) == pytest.approx(float(jd), rel=1e-5)
    assert rel_err(tsm.spmv_chain(tmat, torch.from_numpy(x), 3),
                   jsm.spmv_chain(jmat, jnp.asarray(x), 3)) < 1e-5


@pytest.mark.parametrize("method", ["slab_pack", "slab", "ell"])
def test_spmv_methods_match_reference(method):
    jsm, jnp, jck, jmv = jax_ref()
    m = banded(seed=12)
    x = np.random.default_rng(13).standard_normal(300)
    want = jsm.spmv(jsm.CSR.from_scipy(m), jnp.asarray(x), method=method)
    assert rel_err(tsm.spmv(tsm.CSR.from_scipy(m), torch.from_numpy(x), method=method),
                   want) < 1e-12


def test_spmv_methods_not_ported_raise():
    csr = tsm.CSR.from_scipy(banded())
    with pytest.raises(ValueError, match="unknown method"):
        tsm.spmv(csr, torch.zeros(300), method="nope")
    # the general-matrix methods, ported since, compute
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(300).astype(np.float32))
    for method in ("pallas", "slab_stream", "gell"):
        assert rel_err(tsm.spmv(csr, x, method=method), banded() @ x.numpy()) < 1e-5


# -- ELL -------------------------------------------------------------------------------

@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("seed,skew", [(14, False), (15, True)])
def test_ell_freeze_equals_reference(seed, skew, k):
    jsm, jnp, jck, jmv = jax_ref()
    m = banded(seed=seed, skew_rows=skew).astype(np.float32)
    m = m[:-5]                               # rows not a multiple of ROW_PAD
    je = jsm.CSR.from_scipy(m).to_ell(n_cols_per_row=k)
    te = tsm.CSR.from_scipy(m).to_ell(n_cols_per_row=k)
    for f in ("cols", "vals", "row_nnz"):
        a, b = np.asarray(getattr(je, f)), getattr(te, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (te.nse, te.n_cols_per_row, te.index_dtype) == (je.nse, je.n_cols_per_row,
                                                            torch.int32)
    assert te.n_non_zero_entries() == int(je.n_non_zero_entries())
    assert te.fill_ratio() == pytest.approx(te.n_non_zero_entries() / je.nse)
    assert torch.equal(tsm.COO.from_arrays(*(np.asarray(a) for a in (
        sp.coo_matrix(m).row, sp.coo_matrix(m).col, sp.coo_matrix(m).data)),
        shape=m.shape).to_ell(n_cols_per_row=k).cols, te.cols) or k is not None


def test_ell_round_trip_keeps_stored_zeros():
    m = banded(seed=16).astype(np.float32)
    m.data[[0, 9]] = 0.0
    te = tsm.CSR.from_scipy(m).to_ell()
    back = te.to_csr()
    assert back.n_non_zero_entries() == te.n_non_zero_entries() == m.nnz
    np.testing.assert_array_equal(back.indptr.numpy(), m.indptr)
    np.testing.assert_array_equal(back.indices[:m.nnz].numpy(), m.indices)
    np.testing.assert_array_equal(te.todense().numpy(), m.toarray())
    assert rel_err(tsm.spmv(te.scale(2.0), torch.ones(300)), 2 * (m @ np.ones(300))) < 1e-5
    b = tsm.SparseBuilder()
    b.add_batch(*sp.find(m))
    assert torch.equal(b.to_ell().vals, tsm.CSR.from_scipy(sp.csr_matrix(
        sp.coo_matrix((sp.find(m)[2], sp.find(m)[:2]), shape=m.shape))).to_ell().vals)


# -- checkpoints and from_reference of the new formats --------------------------------------

def arrays_of(v, key="", out=None):
    """Every array of a format (either package's) keyed by its path
    (``parts.0.vals``), static metadata left out."""
    out = {} if out is None else out
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            arrays_of(getattr(v, f.name), f"{key}.{f.name}" if key else f.name, out)
    elif isinstance(v, (tuple, list)):
        for i, e in enumerate(v):
            arrays_of(e, f"{key}.{i}", out)
    elif isinstance(v, torch.Tensor):
        out[key] = v.cpu().numpy()
    elif hasattr(v, "shape") and hasattr(v, "dtype") and not isinstance(v, np.generic):
        out[key] = np.asarray(v)
    return out


def statics_of(v):
    """The static fields the two packages share (buckets, block ids, row
    blocks), nested."""
    out = {}
    for name in ("buckets", "block_ids", "row_block"):
        if hasattr(v, name):
            out[name] = tuple(getattr(v, name)) if name != "row_block" else v.row_block
    if getattr(v, "parts", None):
        out["parts"] = [statics_of(p) for p in v.parts]
    if getattr(v, "overflow", None) is not None:
        out["overflow"] = statics_of(v.overflow)
    return out


def assert_same_matrix(tmat, jmat):
    assert type(tmat).__name__ == type(jmat).__name__ and tmat.shape == tuple(jmat.shape)
    want, got = arrays_of(jmat), arrays_of(tmat)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    assert statics_of(tmat) == statics_of(jmat)


def mixed():
    """A matrix whose default SlabPack has an overflow pack."""
    rng = np.random.default_rng(17)
    n = 400
    deg = np.where(np.arange(n) % 7, 3, 60)
    rows = np.repeat(np.arange(n), deg)
    cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


@pytest.mark.parametrize("fmt", NEW_FORMATS + ["bsr_device"])
def test_checkpoints_load_in_both_packages(fmt, tmp_path):
    jsm, jnp, jck, jmv = jax_ref()
    m = mixed()
    if fmt == "bsr_device":
        jmat = jsm.BSR.from_csr_device(jsm.CSR.from_scipy(m))
        tmat = tsm.BSR.from_csr_device(tsm.CSR.from_scipy(m))
    else:
        jmat, tmat = freeze(jsm, m, fmt), freeze(tsm, m, fmt)
    if fmt == "slab_pack":
        assert tmat.overflow is not None
    x = np.random.default_rng(18).standard_normal(m.shape[1]).astype(np.float32)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_matrix(pj, jmat)
    tck.save_matrix(pt, tmat)
    back_t = tck.load_matrix(pj)            # the JAX package's file in the port
    back_j = jck.load_matrix(pt)            # the port's file in the JAX package
    assert_same_matrix(back_t, jmat)
    assert_same_matrix(tmat, back_j)
    assert rel_err(tsm.spmv(back_t, torch.from_numpy(x)), m @ x) < 1e-5
    assert rel_err(jsm.spmv(back_j, jnp.asarray(x)), m @ x) < 1e-5
    again = tck.load_matrix(pt, device="cpu")
    assert torch.equal(tsm.spmv(again, torch.from_numpy(x)), tsm.spmv(tmat, torch.from_numpy(x)))


def test_checkpoint_of_an_empty_slab_pack(tmp_path):
    jsm, jnp, jck, jmv = jax_ref()
    e = sp.csr_matrix((300, 200), dtype=np.float32)
    tmat = freeze(tsm, e, "slab_pack")
    p = str(tmp_path / "e.npz")
    tck.save_matrix(p, tmat)
    assert_same_matrix(tmat, jck.load_matrix(p))
    assert_same_matrix(tck.load_matrix(p), freeze(jsm, e, "slab_pack"))


def reference_fields(jmat, fmt):
    """The JAX package's frozen arrays as ``from_reference`` takes them."""
    if fmt in ("bsr", "ell"):
        names = {"bsr": ("blocks", "block_rows", "block_cols", "occ", "chunks"),
                 "ell": ("cols", "vals", "row_nnz")}[fmt]
        return {f: (None if getattr(jmat, f) is None else
                    getattr(jmat, f) if f == "chunks" else np.asarray(getattr(jmat, f)))
                for f in names}
    if fmt == "slab":
        return {**{f: None if getattr(jmat, f) is None else np.asarray(getattr(jmat, f))
                   for f in ("vals", "lidx", "win_lo", "bucket_cnt")},
                "buckets": jmat.buckets}
    return {"parts": [reference_fields(p, "slab") for p in jmat.parts],
            "block_ids": jmat.block_ids, "row_block": jmat.row_block,
            "overflow": (None if jmat.overflow is None
                         else reference_fields(jmat.overflow, "slab_pack"))}


@pytest.mark.parametrize("fmt", NEW_FORMATS + ["bsr_device"])
def test_from_reference(fmt):
    jsm, jnp, jck, jmv = jax_ref()
    m = mixed()
    if fmt == "bsr_device":
        jmat, fmt = jsm.BSR.from_csr_device(jsm.CSR.from_scipy(m)), "bsr"
    else:
        jmat = freeze(jsm, m, fmt)
    tmat = from_reference(reference_fields(jmat, fmt), format=fmt, shape=jmat.shape)
    assert_same_matrix(tmat, jmat)
    B = np.random.default_rng(19).standard_normal((m.shape[1], 3)).astype(np.float32)
    assert rel_err(tsm.spmm(tmat, torch.from_numpy(B)), m @ B) < 1e-5
    with pytest.raises(ValueError, match="missing"):
        from_reference({}, format=fmt, shape=jmat.shape)


# -- the slice end to end -------------------------------------------------------------------

def test_spmm_path_end_to_end():
    """SparseBuilder → CSR → BSR (host and device freeze) / SlabPack / SlabELL
    → spmm, against the JAX package; SlabPack → spmv inside BiCGStab."""
    jsm, jnp, jck, jmv = jax_ref()
    rng = np.random.default_rng(20)
    m = mixed()
    n = m.shape[0]
    r, c, v = sp.find(m)
    b = tsm.SparseBuilder()
    b.add_batch(r, c, v)
    tcsr = b.to_csr()
    jcsr = jsm.CSR.from_scipy(m)
    B = rng.standard_normal((n, 16)).astype(np.float32)
    want = jsm.spmm(jsm.BSR.from_csr(jcsr, br=16, bc=256), jnp.asarray(B))
    for mat in (tsm.BSR.from_csr(tcsr, br=16, bc=256),
                tsm.BSR.from_csr_device(tcsr, br=16, bc=256),
                tcsr.to_slab_pack(), tcsr.to_slab()):
        assert rel_err(tsm.spmm(mat, torch.from_numpy(B)), want) < 1e-5

    dom = (m + sp.diags(np.asarray(abs(m).sum(1)).ravel() + 1.0)).tocsr().astype(np.float64)
    rhs = rng.standard_normal(n)
    tol = 1e-10 * float(np.linalg.norm(rhs))
    pk = tsm.CSR.from_scipy(dom).to_slab_pack()
    assert pk.overflow is not None
    rg.reset_launches()
    x, info = tsm.solvers.bicgstab(pk, torch.from_numpy(rhs), tol=tol)
    jx, jinfo = jsm.solvers.bicgstab(jsm.CSR.from_scipy(dom).to_slab_pack(),
                                     jnp.asarray(rhs), tol=tol)
    assert bool(info.converged) and bool(jinfo.converged)
    assert abs(int(info.iterations) - int(jinfo.iterations)) <= 1
    assert rel_err(x, jx) < 1e-8
    assert rg.LAUNCHES == plan_launches({"slab_spmv": 0, "slab_spmm": 0,
                                         "slab_stream_spmv": 0, "slab_stream_spmm": 0})
    assert rg.LAUNCHES["bsr_spmm"] == 0


# -- the SpMM of the plan formats with no SpMM kernel in the JAX package -------------------

#: format → (its freeze, its SpMM's launch key)
PLAN_FORMATS = {"strip": (lambda c: c.to_strip(), "strip_spmm"),
                "well": (lambda c: c.to_well(), "well_spmm"),
                "slab_stream": (lambda c: c.to_slab_stream(), "slab_stream_spmm"),
                "route": (lambda c: c.to_route(), "route_spmm")}


def fem():
    """A small dof-blocked FEM band: 600 rows, 3 dof a node."""
    return matgen.fem_block_band(n_nodes=200, bandwidth=40, seed=3)


PLAN_MATRICES = {"fem": fem, "mixed": mixed}


def conversions():
    """The dispatch's conversions by target, those never made left out."""
    return {k: n for k, n in profiling.trace_record()["counters"]["ops.conversions"].items()
            if n}


@pytest.mark.parametrize("m_rhs", [1, 8, 130])
@pytest.mark.parametrize("name", list(PLAN_MATRICES))
@pytest.mark.parametrize("fmt", list(PLAN_FORMATS))
def test_plan_walk_of_the_plan_formats_matches_csr_spmm(fmt, name, m_rhs):
    """The row-group SpMM's arithmetic, in its order, over the plan that a
    StripELL, WELL, SlabStream or RouteStream launches it on a card: the
    CSR SpMM of the same matrix, and scipy's f64 product."""
    m = PLAN_MATRICES[name]()
    mat = PLAN_FORMATS[fmt][0](tsm.CSR.from_scipy(m))
    B = torch.from_numpy(np.random.default_rng(m_rhs).standard_normal((m.shape[1], m_rhs))
                         .astype(np.float32))
    plan = rg.plan_of(mat)
    assert plan.nnz == m.nnz and (plan.group == 1) == (fmt == "route")
    Y = rg.walk(plan, B)
    assert Y.dtype == torch.float32 and Y.shape == (m.shape[0], m_rhs)
    assert rel_err(Y, tsm.spmm(mat.to_csr(), B)) < 1e-5
    assert rel_err(Y, m.astype(np.float64) @ B.double().numpy()) < 1e-5


@pytest.mark.parametrize("fmt", list(PLAN_FORMATS))
def test_cpu_spmm_of_the_plan_formats_goes_through_csr(fmt):
    """On the CPU the dispatch takes the plain path: one conversion to CSR a
    call, the CSR's own SpMM, no launch."""
    m = mixed()
    freeze, name = PLAN_FORMATS[fmt]
    mat = freeze(tsm.CSR.from_scipy(m))
    B = torch.from_numpy(np.random.default_rng(5).standard_normal((m.shape[1], 8))
                         .astype(np.float32))
    profiling.reset_trace()
    try:
        with profiling.tracing():
            Y = tsm.spmm(mat, B)
            assert torch.equal(mat @ B, Y)
            assert torch.equal(tsm.spmm(mat, B), Y)
        assert conversions() == {"csr": 3}
        assert rg.LAUNCHES[name] == 0
    finally:
        profiling.reset_trace()
    assert torch.equal(Y, tsm.spmm(mat.to_csr(), B))
    assert rel_err(Y, m.astype(np.float64) @ B.double().numpy()) < 1e-5


# -- the dispatch on a CUDA card (needs a card) ------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_dispatch_goes_through_the_kernels(cuda):
    m = mixed()
    csr = tsm.CSR.from_scipy(m, device=cuda)
    B = torch.randn(m.shape[1], 9, device=cuda)
    x = B[:, 0].contiguous()
    want = torch.from_numpy(m.astype(np.float64) @ B.double().cpu().numpy())
    rg.reset_launches()
    for mat in (tsm.BSR.from_csr(csr), tsm.BSR.from_csr_device(csr, br=64, bc=256),
                csr.to_slab_pack(), csr.to_slab()):
        assert rel_err((mat @ B).cpu(), want) < 1e-5
        assert rel_err(tsm.spmm(mat, B).cpu(), want) < 1e-5
    for method in ("pallas", "slab_pack", "slab"):
        assert rel_err(tsm.spmm(csr, B, method=method).cpu(), want) < 1e-5
    for mat in (csr.to_slab_pack(), csr.to_slab()):
        assert rel_err(tsm.spmv(mat, x).cpu(), want[:, 0]) < 1e-5
    torch.cuda.synchronize()
    assert rg.LAUNCHES["bsr_spmm"] == 5
    assert csr.to_slab_pack().overflow is not None         # the SlabPack has an overflow pack
    assert rg.LAUNCHES == plan_launches({"bsr_spmm": 5,
                                         "slab_spmm": 6,                # one launch a product
                                         "slab_spmv": 2, "slab_stream_spmv": 0,
                                         "slab_stream_spmm": 0})
    for mat in (csr, csr.to_ell(), csr.to_coo()):          # no kernel of their own
        assert rel_err(tsm.spmm(mat, B).cpu(), want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PLAN_MATRICES))
@pytest.mark.parametrize("fmt", list(PLAN_FORMATS))
def test_cuda_spmm_of_the_plan_formats_launches_the_rowgroup_kernel(cuda, fmt, name):
    """StripELL, WELL, SlabStream and RouteStream: one launch of the row-group
    SpMM a call over the matrix's plan, and no conversion, at m = 1, 9 (a
    ragged tile, scalar loads) and 128 (16-byte loads)."""
    m = PLAN_MATRICES[name]()
    freeze, launch = PLAN_FORMATS[fmt]
    mat = freeze(tsm.CSR.from_scipy(m, device=cuda))
    profiling.reset_trace()
    try:
        for k, m_rhs in enumerate((1, 9, 128)):
            B = torch.randn(m.shape[1], m_rhs, device=cuda)
            want = m.astype(np.float64) @ B.double().cpu().numpy()
            with profiling.tracing():
                Y = tsm.spmm(mat, B)
                torch.cuda.synchronize()
                assert rg.LAUNCHES[launch] == 2 * k + 1
                assert torch.equal(mat @ B, Y)               # reruns bitwise
            assert Y.dtype == torch.float32 and Y.shape == (m.shape[0], m_rhs)
            assert rel_err(Y.cpu(), want) < 1e-5
            assert rel_err(Y.cpu(), rg.walk(rg.plan_of(mat), B).cpu()) < 1e-5
        assert conversions() == {}
        assert rg.LAUNCHES[launch] == 6
    finally:
        profiling.reset_trace()


# -- the row-group SpMM below a full column tile: sub-warps of spmm_lanes lanes ------------

#: widths of B on both sides of each sub-warp width's limit, and a full f32 tile
NARROW_M = (1, 2, 3, 4, 5, 8, 16, 17, 32, 33, 64, 65, 128)


def kernel_columns(m_rhs, width, lanes, vec):
    """The columns of B the SpMM kernel's lane slots write at ``lanes``
    lanes a row group and ``width`` columns a lane, in column tiles of
    lanes·width: a lane's 16-byte slice at lane·width (written whole where
    it starts inside m), or its columns lane + lanes·w (each masked)."""
    tile = lanes * width
    out = []
    for j0 in range(0, m_rhs, tile):
        for s in range(lanes):
            if vec:
                if j0 + s * width < m_rhs:
                    out += [j0 + s * width + w for w in range(width)]
            else:
                out += [c for c in (j0 + s + lanes * w for w in range(width)) if c < m_rhs]
    return out


@pytest.mark.parametrize("vec", [True, False], ids=["16-byte", "scalar"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("m_rhs", NARROW_M)
def test_spmm_lanes_are_the_fewest_that_cover_each_column_once(m_rhs, dt, vec):
    """The lane rule: the fewest lanes a row group (a power of two) whose
    16-byte slices cover m, a whole warp past 16 of them; one column tile
    below a warp.  Either path then writes each column of Y once, the
    16-byte one exactly where m is a multiple of its width (elsewhere the
    launch takes the scalar one)."""
    itemsize = torch.empty(0, dtype=dt).element_size()
    width = 16 // itemsize
    lanes = rg.spmm_lanes(m_rhs, itemsize)
    assert lanes in rg.SPMM_LANES and lanes & (lanes - 1) == 0
    assert (lanes == 32) == (m_rhs > 16 * width)
    if lanes < 32:
        assert lanes * width >= m_rhs and (lanes == 1 or lanes // 2 * width < m_rhs)
    cols = kernel_columns(m_rhs, width, lanes, vec)
    if vec and m_rhs % width:
        assert max(cols) >= m_rhs                # a slice runs past m: not this path
    else:
        assert sorted(cols) == list(range(m_rhs))


@pytest.mark.parametrize("fmt", list(PLAN_FORMATS))
def test_cpu_spmm_counts_no_lane_width(fmt):
    """The plain versions launch nothing, so ``kernels.spmm_lanes`` stays at
    zero whatever the width."""
    m = fem()
    mat = PLAN_FORMATS[fmt][0](tsm.CSR.from_scipy(m))
    rg.reset_launches()
    for m_rhs in (1, 8, 64, 128):
        B = torch.from_numpy(np.random.default_rng(m_rhs).standard_normal((m.shape[1], m_rhs))
                             .astype(np.float32))
        assert rel_err(tsm.spmm(mat, B), m.astype(np.float64) @ B.double().numpy()) < 1e-5
    assert set(rg.LANE_LAUNCHES) == {str(L) for L in rg.SPMM_LANES}
    assert not any(rg.LANE_LAUNCHES.values())
    assert profiling.COUNTERS["kernels.spmm_lanes"] is rg.LANE_LAUNCHES


def power_law():
    """The circuit surrogate at a small size: Zipf row lengths to a few
    dozen beside rows of one or two, columns scattered."""
    return matgen.circuit_scatter(n=3000, seed=1)


#: every planned format's freeze of a CSR
NARROW_FORMATS = {"bsr": lambda c: tsm.BSR.from_csr(c), "slab": lambda c: c.to_slab(),
                  "slab_pack": lambda c: c.to_slab_pack(),
                  **{k: f for k, (f, _) in PLAN_FORMATS.items()}}
NARROW_MATRICES = {**PLAN_MATRICES, "power_law": power_law}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(NARROW_MATRICES))
@pytest.mark.parametrize("fmt", list(NARROW_FORMATS))
def test_cuda_narrow_spmm_is_the_full_tile_product_bitwise(cuda, fmt, name, dt):
    """At every width of ``NARROW_M``, on the 16-byte path (B fresh) and on
    the scalar one (B a view one element into its storage, 4 bytes in f32,
    so 16-byte loads are off; or m not a multiple of the lane's width): Y
    is bitwise the same columns of the product with a 128-wide B (those
    columns, then seeded padding), which takes whole warps; within the
    tolerance of scipy's f64 product; and bitwise equal on a rerun.  Each
    launch counts under its ``spmm_lanes``."""
    m = NARROW_MATRICES[name]()
    np_dt = np.float32 if dt == torch.float32 else np.float64
    mat = NARROW_FORMATS[fmt](tsm.CSR.from_scipy(m.astype(np_dt), device=cuda))
    n_cols = m.shape[1]
    gen = torch.Generator(device=cuda).manual_seed(23)
    wide = torch.randn(n_cols, 128, dtype=dt, device=cuda, generator=gen)
    want = m.astype(np.float64) @ wide.double().cpu().numpy()
    for m_rhs in NARROW_M:
        lanes = str(rg.spmm_lanes(m_rhs, wide.element_size()))
        for offset in (0, 1):
            B = torch.empty(n_cols * m_rhs + offset, dtype=dt, device=cuda)[offset:]
            B = B.view(n_cols, m_rhs)
            B.copy_(wide[:, :m_rhs])
            padded = torch.cat([B, torch.randn(n_cols, 128 - m_rhs, dtype=dt, device=cuda,
                                               generator=gen)], 1)
            Y_wide = tsm.spmm(mat, padded)
            rg.reset_launches()
            Y = tsm.spmm(mat, B)
            again = tsm.spmm(mat, B)
            torch.cuda.synchronize()
            what = f"m={m_rhs} offset={offset}"
            assert Y.dtype == dt and Y.shape == (m.shape[0], m_rhs), what
            assert torch.equal(Y, Y_wide[:, :m_rhs]), what
            assert torch.equal(again, Y), what
            assert rel_err(Y.cpu(), want[:, :m_rhs]) < TOL[np_dt], what
            assert rg.LANE_LAUNCHES == dict.fromkeys(rg.LANE_LAUNCHES, 0) | {lanes: 2}, what
