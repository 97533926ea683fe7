"""The general-matrix slice of the port against the JAX package on the same
inputs: the SELL and GELL freezes give the same arrays bit for bit; GELL's
SpMV and SpMM, ``rmatvec`` on every format, ``spmv(method='dia')`` and
``'dia_xla'`` and ``auto_format``'s choice on the CPU match the JAX
package's; BiCGStab over WELL and PCG over SlabStream match the JAX solvers;
``interop.from_reference`` builds the new formats from the JAX package's
arrays.  Also the repairs this slice made: an entry point called without
``device=`` lands on the current CUDA card and raises where there is none,
and every source the port compiles lies in the port.

Tolerances: relative to max|reference|, 1e-5 in f32 (another summation
order), 1e-12 in f64.  Solves in f64: x to 1e-8; PCG's iteration counts
within one, BiCGStab's within two (its recurrences amplify the other
summation order: on this system the two packages' CSR solves already differ
by one step).
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu, real_default_device  # noqa: F401  (autouse)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import _build, checkpoint, interop, native, types
from sparsemat_tpu_torch import io as tio
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.ops import matvec as tmv

PORT_DIR = os.path.dirname(os.path.abspath(tsm.__file__))


def mixed_degree(n=2000, seed=0):
    """tests/test_gell_pack.py's interleaved light and heavy rows."""
    rng = np.random.default_rng(seed)
    deg = np.where(np.arange(n) % 7, 3, 60)
    rows = np.repeat(np.arange(n), deg)
    cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def scatter_matrix(n=4000, seed=1):
    """tests/test_gell_pack.py's power-law scattered rows."""
    rng = np.random.default_rng(seed)
    deg = rng.zipf(2.1, n).clip(1, n // 20)
    src = np.repeat(np.arange(n), deg)
    m = sp.coo_matrix((rng.standard_normal(src.size), (src, rng.integers(0, n, src.size))),
                      shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def empty_row_scatter():
    m = scatter_matrix(n=800, seed=9).tolil()
    m[5] = 0
    m = m.tocsr()
    m.eliminate_zeros()
    return m.astype(np.float32)


def stored_zero():
    m = scatter_matrix(n=500, seed=3)
    m.data[[0, 4, 40]] = 0.0                 # stored entries whose value is zero
    return m


def poisson(n=24):
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    return sp.kronsum(t, t, format="csr").astype(np.float32)


MATRICES = {
    "scatter_4000": lambda: scatter_matrix(4000, 1),
    "scatter_seed8": lambda: scatter_matrix(seed=8),
    "empty_row_800": empty_row_scatter,
    "mixed_2000": lambda: mixed_degree(2000, 0),
    "stored_zero": stored_zero,
    "random_300": lambda: sp.random(300, 300, 0.05, random_state=np.random.default_rng(0),
                                    format="csr", dtype=np.float32),
    "wide_64x1000": lambda: sp.random(64, 1000, 0.02, random_state=np.random.default_rng(1),
                                      format="csr", dtype=np.float32),
    "tall_1000x64": lambda: sp.random(1000, 64, 0.02, random_state=np.random.default_rng(2),
                                      format="csr", dtype=np.float32),
}


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_ref():
    jsm = pytest.importorskip("sparsemat_tpu")
    return jsm


def both(m):
    jsm = jax_ref()
    return jsm.CSR.from_scipy(m), tsm.CSR.from_scipy(m)


def assert_arrays_equal(pairs):
    for name, a, b in pairs:
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


# -- SELL and GELL freezes ----------------------------------------------------------

@pytest.mark.parametrize("sigma", [None, 16])
@pytest.mark.parametrize("name", list(MATRICES) + ["nnz0"])
def test_sell_freeze_equals_reference(name, sigma):
    m = MATRICES[name]() if name != "nnz0" else sp.csr_matrix((30, 20), dtype=np.float32)
    jc, tc = both(m)
    js, ts = jc.to_sell(), tsm.SELL.from_csr(tc, sigma=sigma)
    if sigma is not None:
        js = type(js).from_csr(jc, sigma=sigma)
    assert ts.shape == tuple(js.shape) and ts.slice_height == js.slice_height
    assert_arrays_equal((f, getattr(js, f), getattr(ts, f))
                        for f in ("slot_rows", "slot_cols", "slot_vals", "slice_offsets"))
    assert ts.n_non_zero_entries() == int(js.n_non_zero_entries()) == m.nnz
    assert ts.padding_ratio() == pytest.approx(js.padding_ratio(), rel=1e-12)


def assert_gell_equal(jg, tg):
    assert tg.shape == tuple(jg.shape) and tg.n_levels == jg.n_levels
    pairs = []
    for i, (a, b) in enumerate(zip(jg.levels, tg.levels)):
        assert b.shape == tuple(a.shape)
        pairs += [(f"levels.{i}.{f}", getattr(a, f), getattr(b, f))
                  for f in ("cols", "vals", "row_nnz")]
    for f in ("inv_maps", "level_rows"):
        assert len(getattr(tg, f)) == len(getattr(jg, f))
        pairs += [(f"{f}.{i}", a, b) for i, (a, b) in enumerate(zip(getattr(jg, f),
                                                                   getattr(tg, f)))]
    assert_arrays_equal(pairs)


@pytest.mark.parametrize("k0", [None, 2])
@pytest.mark.parametrize("name", MATRICES)
def test_gell_freeze_equals_reference(name, k0):
    m = MATRICES[name]()
    jc, tc = both(m)
    jg, tg = jc.to_gell(k0=k0), tc.to_gell(k0=k0)
    assert_gell_equal(jg, tg)
    assert tg.nse == jg.nse and tg.n_non_zero_entries() == int(jg.n_non_zero_entries()) == m.nnz
    assert tg.spmv_traffic_bytes() == jg.spmv_traffic_bytes()
    assert tg.fill_ratio() == pytest.approx(jg.fill_ratio(), rel=1e-12)


def test_gell_freeze_of_nnz0_raises_as_the_reference_does():
    """A reference quirk kept: the JAX GELL freeze indexes an empty column
    array on a matrix with no entries (``auto_format`` never asks it to)."""
    jc, tc = both(sp.csr_matrix((20, 30), dtype=np.float32))
    with pytest.raises(IndexError):
        jc.to_gell()
    with pytest.raises(IndexError):
        tc.to_gell()


def test_gell_round_trip_astype_and_scale():
    m = stored_zero()
    tg = tsm.CSR.from_scipy(m).to_gell()
    back = tg.to_csr()
    got = sp.csr_matrix((back.data.numpy(), back.indices.numpy(), back.indptr.numpy()),
                        shape=back.shape)
    assert back.n_non_zero_entries() == m.nnz and (got != m).nnz == 0
    g64 = tg.scale(2.0).astype(torch.float64)
    assert g64.dtype == torch.float64 and all(l.vals.dtype == torch.float64 for l in g64.levels)
    x = np.random.default_rng(3).standard_normal(500)
    assert rel_err(tsm.spmv(g64, torch.from_numpy(x)), 2 * (m.astype(np.float64) @ x)) < 1e-12
    jsm = jax_ref()
    jg = jsm.CSR.from_scipy(m).to_gell()
    jcoo, tcoo = jg.to_coo(), tg.to_coo()
    assert_arrays_equal((f, getattr(jcoo, f), getattr(tcoo, f)) for f in ("rows", "cols", "vals"))


# -- GELL SpMV / SpMM, rmatvec and the DIA methods against the JAX package -----------

@pytest.mark.parametrize("name", ["scatter_4000", "empty_row_800", "mixed_2000"])
def test_gell_spmv_and_spmm_match_reference(name):
    import jax.numpy as jnp
    from sparsemat_tpu.ops import matvec as jmv

    m = MATRICES[name]()
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        jc, tc = both(m.astype(dt))
        jg, tg = jc.to_gell(), tc.to_gell()
        x = np.random.default_rng(7).standard_normal(m.shape[1]).astype(dt)
        got = tmv._gell_spmv(tg, torch.from_numpy(x))
        assert rel_err(got, jmv._gell_spmv(jg, jnp.asarray(x))) < tol
        assert torch.equal(tsm.spmv(tg, torch.from_numpy(x)), got)
        assert torch.equal(tsm.spmv(tc, torch.from_numpy(x), method="gell"), got)
        B = np.random.default_rng(10).standard_normal((m.shape[1], 5)).astype(dt)
        Y = tmv._gell_spmm(tg, torch.from_numpy(B))
        assert rel_err(Y, jmv._gell_spmm(jg, jnp.asarray(B))) < tol
        assert torch.equal(tsm.spmm(tc, torch.from_numpy(B), method="gell"), Y)
        assert rel_err(Y, m.astype(np.float64) @ B.astype(np.float64)) < tol


RMATVEC_FORMATS = ["coo", "csr", "dia", "ell", "sell", "bsr", "strip", "route", "slab",
                   "slab_pack", "slab_stream", "well", "gell"]


@pytest.mark.parametrize("fmt", RMATVEC_FORMATS)
def test_rmatvec_matches_reference_on_every_format(fmt):
    import jax.numpy as jnp

    jsm = jax_ref()
    m = sp.random(260, 190, 0.04, random_state=np.random.default_rng(11), format="csr",
                  dtype=np.float32)
    m.data[3] = 0.0
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        md = m.astype(dt)
        jc, tc = both(md)
        mat = {"csr": tc, "bsr": tsm.BSR.from_csr(tc)}.get(fmt) or getattr(tc, f"to_{fmt}")()
        y = np.random.default_rng(12).standard_normal(260).astype(dt)
        got = tsm.rmatvec(mat, torch.from_numpy(y))
        assert got.shape == (190,) and got.dtype == torch.from_numpy(y).dtype
        assert rel_err(got, jsm.ops.rmatvec(jc, jnp.asarray(y))) < tol
        assert rel_err(got, md.T.astype(np.float64) @ y.astype(np.float64)) < tol
        assert torch.equal(tsm.rmatvec(mat, torch.from_numpy(y)), got)    # the cached order


def test_rmatvec_edges():
    empty = tsm.CSR.from_scipy(sp.csr_matrix((4, 6), dtype=np.float32))
    assert torch.equal(tsm.rmatvec(empty, torch.ones(4)), torch.zeros(6))
    with pytest.raises(ValueError):
        tsm.rmatvec(empty, torch.ones(6))
    lo = tsm.CSR.from_scipy(MATRICES["random_300"]()).astype(torch.bfloat16)
    got = tsm.rmatvec(lo, torch.ones(300, dtype=torch.bfloat16))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("method", ["dia", "dia_xla"])
def test_spmv_dia_methods_match_reference(method):
    import jax.numpy as jnp

    jsm = jax_ref()
    m = poisson()
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        jc, tc = both(m.astype(dt))
        x = np.random.default_rng(13).standard_normal(m.shape[1]).astype(dt)
        got = tsm.spmv(tc, torch.from_numpy(x), method=method)
        assert got.dtype == torch.from_numpy(x).dtype
        assert rel_err(got, jsm.spmv(jc, jnp.asarray(x), method=method)) < tol
        assert torch.equal(tsm.spmv(tc.to_dia(), torch.from_numpy(x), method=method), got)


# -- auto_format ------------------------------------------------------------------------

def skewed_rows(n=600, seed=4):
    """Row lengths spread over 1..40 (ELL pads too much, SELL slices do not)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 41, n)
    rows = np.repeat(np.arange(n), deg)
    m = sp.coo_matrix((rng.standard_normal(rows.size), (rows, rng.integers(0, n, rows.size))),
                      shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def fem_band(n=3000, seed=5):
    """Scattered entries within a 300-wide band plus a diagonal."""
    rng = np.random.default_rng(seed)
    deg = np.where(np.arange(n) % 5, 6, 30)
    rows = np.repeat(np.arange(n), deg)
    cols = np.clip(rows + rng.integers(-150, 151, rows.size), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    m = m + sp.eye(n, format="csr")
    m.sum_duplicates()
    return m.astype(np.float32)


AUTO = {"poisson": poisson, "tight_random": lambda: sp.random(
            400, 400, 0.05, random_state=np.random.default_rng(6), format="csr",
            dtype=np.float32),
        "skewed_rows": skewed_rows, "fem_band": fem_band, "mixed_2000": MATRICES["mixed_2000"],
        "scatter_4000": MATRICES["scatter_4000"],
        "empty": lambda: sp.csr_matrix((40, 40), dtype=np.float32)}


@pytest.mark.parametrize("ell_waste", [2.0, 0.5])
@pytest.mark.parametrize("name", AUTO)
def test_auto_format_picks_the_reference_class_on_the_cpu(name, ell_waste):
    """The default waste, and one below 1 that pushes past ELL and SELL
    (as the JAX package's own test does) to reach StripELL, SlabPack and
    GELL."""
    jsm = jax_ref()
    m = AUTO[name]()
    jc, tc = both(m)
    want = type(jsm.formats.auto_format(jc, max_ell_waste=ell_waste)).__name__
    got = tsm.auto_format(tc, max_ell_waste=ell_waste)
    assert type(got).__name__ == want
    x = np.random.default_rng(14).standard_normal(m.shape[1]).astype(np.float32)
    assert rel_err(tsm.spmv(got, torch.from_numpy(x)), m @ x) < 1e-5


def test_auto_format_covers_the_cpu_order():
    """Across the matrices above, the CPU order reaches DIA, ELL, SELL,
    StripELL and GELL."""
    picked = {type(tsm.auto_format(tsm.CSR.from_scipy(f()), max_ell_waste=w)).__name__
              for f in AUTO.values() for w in (2.0, 0.5)}
    assert {"CSR", "DIA", "ELL", "SELL", "StripELL", "GELL"} <= picked


def test_auto_format_skips_the_slab_freeze_on_global_scatter(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("SlabPack.from_csr called despite the cheap pre-guard")

    monkeypatch.setattr(tsm.SlabPack, "from_csr", boom)
    m = sp.random(4000, 60000, 0.0005, format="csr", dtype=np.float32,
                  random_state=np.random.default_rng(0))
    assert isinstance(tsm.auto_format(tsm.CSR.from_scipy(m), max_ell_waste=0.5), tsm.GELL)


# -- solvers over the new formats ------------------------------------------------------

def dominant(m, skew=0.0):
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


def test_bicgstab_over_well_matches_reference():
    import jax.numpy as jnp

    jsm = jax_ref()
    m = dominant(scatter_matrix(600, 2), skew=0.5)
    b = np.random.default_rng(15).standard_normal(600)
    x, info = tsm.solvers.bicgstab(tsm.CSR.from_scipy(m).to_well(), torch.from_numpy(b),
                                   tol=1e-10)
    jx, jinfo = jsm.solvers.bicgstab(jsm.CSR.from_scipy(m).to_well(), jnp.asarray(b), tol=1e-10)
    assert bool(info.converged) and bool(jinfo.converged)
    assert abs(int(info.iterations) - int(jinfo.iterations)) <= 2
    assert rel_err(x, jx) < 1e-8
    assert np.linalg.norm(b - m @ x.numpy()) <= 1e-9


def test_pcg_jacobi_over_slab_stream_matches_reference():
    import jax.numpy as jnp

    jsm = jax_ref()
    mm = mixed_degree(1100, 22).astype(np.float64)
    m = dominant((mm + mm.T) * 0.5)
    b = np.random.default_rng(16).standard_normal(1100)
    tc, jc = tsm.CSR.from_scipy(m), jsm.CSR.from_scipy(m)
    x, info = tsm.solvers.cg(tc.to_slab_stream(rb=128), torch.from_numpy(b), tol=1e-10,
                             M=tsm.solvers.JacobiPreconditioner.from_matrix(tc))
    jx, jinfo = jsm.solvers.cg(jc.to_slab_stream(rb=128), jnp.asarray(b), tol=1e-10,
                               M=jsm.solvers.JacobiPreconditioner.from_matrix(jc))
    assert bool(info.converged) and bool(jinfo.converged)
    assert abs(int(info.iterations) - int(jinfo.iterations)) <= 1
    assert rel_err(x, jx) < 1e-8


# -- interop -----------------------------------------------------------------------------

def jax_fields(mat):
    import dataclasses

    return {f.name: np.asarray(getattr(mat, f.name)) if hasattr(getattr(mat, f.name), "shape")
            else getattr(mat, f.name) for f in dataclasses.fields(mat) if f.name != "shape"}


@pytest.mark.parametrize("fmt", ["well", "slab_stream", "sell", "gell"])
def test_from_reference_builds_the_new_formats(fmt):
    jsm = jax_ref()
    m = MATRICES["stored_zero"]()
    jc, tc = both(m)
    jmat = getattr(jc, f"to_{fmt}")()
    fields = jax_fields(jmat)
    if fmt == "gell":
        fields = {"levels": [dict(jax_fields(l), shape=l.shape) for l in jmat.levels],
                  "inv_maps": [np.asarray(a) for a in jmat.inv_maps],
                  "level_rows": [np.asarray(a) for a in jmat.level_rows]}
    got = interop.from_reference(fields, format=fmt, shape=jmat.shape, device="cpu")
    want = getattr(tc, f"to_{fmt}")()
    assert type(got) is type(want) and got.shape == want.shape
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(500).astype(np.float32))
    assert torch.equal(tsm.spmv(got, x), tsm.spmv(want, x))
    assert got.n_non_zero_entries() == m.nnz


def test_from_reference_well_without_row_cnt_and_unknown_fields():
    jsm = jax_ref()
    jw = jsm.CSR.from_scipy(MATRICES["random_300"]()).to_well()
    fields = dict(jax_fields(jw), row_cnt=None)
    got = interop.from_reference(fields, format="well", shape=jw.shape, device="cpu")
    assert got.row_cnt is None and got.n_non_zero_entries() == int(np.count_nonzero(jw.vals))
    with pytest.raises(ValueError, match="unknown fields"):
        interop.from_reference(dict(fields, bogus=1), format="well", shape=jw.shape,
                               device="cpu")


def test_port_written_well_runs_the_reference_chunked_kernel(tmp_path):
    """A WELL the port saves carries the JAX freeze's ``chunks``, so the
    JAX package's TPU kernel (interpret mode here) runs on it as loaded."""
    import jax.numpy as jnp
    from sparsemat_tpu import checkpoint as jck
    from sparsemat_tpu.kernels import spmv as jkv

    jsm = jax_ref()
    m = MATRICES["wide_64x1000"]()
    tw = tsm.CSR.from_scipy(m).to_well()
    p = str(tmp_path / "well.npz")
    checkpoint.save_matrix(p, tw)
    back = jck.load_matrix(p)
    assert back.chunks == jsm.CSR.from_scipy(m).to_well().chunks
    x = np.random.default_rng(18).standard_normal(1000).astype(np.float32)
    assert rel_err(jkv.well_spmv_pallas(back, jnp.asarray(x), interpret=True), m @ x) < 1e-5


# -- the repairs: the card is the default, the port builds its own sources --------------

def _mtx(tmp_path):
    p = str(tmp_path / "a.mtx")
    tio.save_mtx(tsm.CSR.from_scipy(poisson(4), device="cpu"), p)
    return p


def _npz(tmp_path):
    p = str(tmp_path / "a.npz")
    checkpoint.save_matrix(p, tsm.CSR.from_scipy(poisson(4), device="cpu"))
    return p


def _builder():
    b = tsm.SparseBuilder()
    b.add_to(0, 1, 2.0)
    b.add_to(1, 0, 3.0)
    return b


ENTRY_POINTS = {
    "CSR.from_arrays": lambda d, tp: tsm.CSR.from_arrays(
        np.array([0, 1]), np.array([0]), np.array([1.0], np.float32), (1, 1), **d),
    "CSR.from_host_coo": lambda d, tp: tsm.CSR.from_host_coo(
        np.array([0]), np.array([0]), np.array([1.0], np.float32), (1, 1), **d),
    "CSR.from_scipy": lambda d, tp: tsm.CSR.from_scipy(poisson(3), **d),
    "CSR.from_dense": lambda d, tp: tsm.CSR.from_dense(np.eye(3, dtype=np.float32), **d),
    "CSR.eye": lambda d, tp: tsm.CSR.eye(3, **d),
    "COO.from_arrays": lambda d, tp: tsm.COO.from_arrays(
        np.array([0]), np.array([0]), np.array([1.0], np.float32), (1, 1), **d).rows,
    "COO.from_dense": lambda d, tp: tsm.COO.from_dense(np.eye(3, dtype=np.float32), **d),
    "COO.eye": lambda d, tp: tsm.COO.eye(3, **d),
    "SparseBuilder.to_coo": lambda d, tp: _builder().to_coo(**d),
    "SparseBuilder.to_csr": lambda d, tp: _builder().to_csr(**d),
    "SparseBuilder.to_ell": lambda d, tp: _builder().to_ell(**d),
    "SparseBuilder.freeze": lambda d, tp: _builder().freeze("csr", **d),
    # mvp takes its device from x: a CPU tensor asks for the CPU, a list names none
    "SparseBuilder.mvp": lambda d, tp: _builder().mvp(
        torch.ones(2) if d else [1.0, 1.0]),
    "io.load_mtx": lambda d, tp: tio.load_mtx(_mtx(tp), **d),
    "checkpoint.load_matrix": lambda d, tp: checkpoint.load_matrix(_npz(tp), **d),
    "interop.from_reference": lambda d, tp: interop.from_reference(
        {"rows": np.array([0], np.int32), "cols": np.array([0], np.int32),
         "vals": np.array([1.0], np.float32)}, format="coo", shape=(1, 1), **d),
    "DenseVec.to_torch": lambda d, tp: tsm.DenseVec(np.ones(3, np.float32)).to_torch(**d),
    "SparseVec.to_torch": lambda d, tp: tsm.SparseVec(
        np.array([1]), np.array([2.0], np.float32), 3).to_torch(**d),
    "eye": lambda d, tp: tsm.eye(3, **d),
    "from_dense": lambda d, tp: tsm.from_dense(np.eye(3, dtype=np.float32), **d),
}


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_without_device_raises_where_there_is_no_card(entry, tmp_path, monkeypatch):
    call = ENTRY_POINTS[entry]
    assert call({"device": "cpu"}, tmp_path).device.type == "cpu"   # asked for the CPU
    monkeypatch.setattr(types, "default_device", real_default_device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call({}, tmp_path)


def test_default_device_is_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert real_default_device() == torch.device("cuda", 2)
    assert types.resolve_device("cpu") == torch.device("cpu")


def test_every_compiled_source_lies_in_the_port(monkeypatch):
    compiled = []

    def record(name, compiler, sources):
        compiled.extend(sources)
        raise OSError("recorded")

    monkeypatch.setattr(_build, "compile_shared", record)
    monkeypatch.setattr(native, "compile_shared", record)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_error", None)
    assert native.get_lib() is None
    cu = sorted(f[:-3] for f in os.listdir(os.path.join(PORT_DIR, "csrc")) if f.endswith(".cu"))
    assert cu == ["dia", "krylov", "route", "spmm", "spmv"]
    for name in cu:
        with pytest.raises(OSError, match="recorded"):
            _build.load_cuda(name)
    assert len(compiled) == 2 + len(cu)
    for src in compiled:
        assert os.path.commonpath([os.path.abspath(src), PORT_DIR]) == PORT_DIR, src
        assert os.path.exists(src), src
    for mod in (_build, native):
        text = open(mod.__file__).read()
        assert '"sparsemat_tpu",' not in text and "sparsemat_tpu/native" not in text


# -- the dispatch on a CUDA card (needs a card) -----------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_general_path_goes_through_the_kernels(cuda):
    m = mixed_degree(1100, 22)
    csr = tsm.CSR.from_scipy(m, device=cuda)
    x = torch.randn(1100, device=cuda)
    want = torch.from_numpy(m.astype(np.float64) @ x.double().cpu().numpy())
    rg.reset_launches()
    for method in ("pallas", "well", "slab_stream", "gell", "dia", "dia_xla"):
        assert rel_err(tsm.spmv(csr, x, method=method).cpu(), want) < 1e-5, method
    assert torch.equal(tsm.spmv(csr, x, method="pallas"), tsm.spmv(csr.to_well(), x))
    torch.cuda.synchronize()
    assert rg.LAUNCHES["well_spmv"] == 4 and rg.LAUNCHES["slab_stream_spmv"] == 1
    y = torch.randn(1100, device=cuda)
    r = tsm.rmatvec(csr.to_well(), y)
    assert rel_err(r.cpu(), m.T.astype(np.float64) @ y.double().cpu().numpy()) < 1e-5
    assert torch.equal(tsm.rmatvec(csr.to_well(), y), r)


@pytest.mark.cuda
def test_cuda_auto_format_takes_the_card_order(cuda):
    picks = {name: type(tsm.auto_format(tsm.CSR.from_scipy(AUTO[name](), device=cuda))).__name__
             for name in ("poisson", "skewed_rows", "fem_band", "scatter_4000")}
    assert picks["poisson"] == "DIA" and picks["fem_band"] == "StripELL"
    assert picks["scatter_4000"] == "RouteStream" and picks["skewed_rows"] != "SELL"
