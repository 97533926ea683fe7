"""The port's MatrixMarket I/O and checkpoints against the JAX package's:
``load_mtx`` gives the same CSR arrays as the JAX package's on every
fixture (and the same matrix as scipy), a truncated file raises, each
package reads the other's ``.mtx`` and ``.npz`` files, the rendering is the
same text, and a solve checkpointed in one package resumes in the other.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import checkpoint as tck
from sparsemat_tpu_torch import io as tio
from sparsemat_tpu_torch import solvers as ts

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(DATA, "*.mtx")))
FORMATS = ["coo", "csr", "dia", "strip", "route", "well", "slab_stream", "sell", "gell"]
CSR_ARRAYS = ("indptr", "indices", "data", "row_ids")


def jax_ref():
    jsm = pytest.importorskip("sparsemat_tpu")
    from sparsemat_tpu import checkpoint as jck
    from sparsemat_tpu import io as jio

    return jsm, jio, jck


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30) if b.size else 0.0


def assert_csr_equal(tcsr, jcsr):
    assert tcsr.shape == tuple(jcsr.shape)
    for f in CSR_ARRAYS:
        a = np.asarray(getattr(jcsr, f))
        b = getattr(tcsr, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


# -- MatrixMarket ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", FIXTURES)
def test_load_mtx_equals_reference_and_scipy(name, dtype):
    _, jio, _ = jax_ref()
    path = os.path.join(DATA, name)
    got = tio.load_mtx(path, dtype=dtype)
    assert tio.last_mtx_parser == "native"
    assert_csr_equal(got, jio.load_mtx(path, dtype=dtype))
    assert got.dtype == tsm.types.as_torch_dtype(dtype)
    want = sp.csr_matrix(sio.mmread(path)).toarray()
    np.testing.assert_allclose(got.todense().numpy(), want,
                               rtol=1e-6 if dtype == np.float32 else 1e-14)


@pytest.mark.parametrize("name", FIXTURES)
def test_numpy_reader_agrees_with_native(name):
    path = os.path.join(DATA, name)
    a = tio.load_mtx(path, dtype=np.float64)
    b = tio._load_mtx_numpy(path, dtype=np.float64)
    for f in CSR_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy())


def test_load_mtx_uploads_to_the_device_asked_for():
    csr = tio.load_mtx(os.path.join(DATA, "skew_4x4.mtx"), device="cpu")
    assert csr.device == torch.device("cpu") and csr.indptr.device == torch.device("cpu")


def test_load_mtx_rejects_a_truncated_file(tmp_path):
    m = sp.random(50, 50, 0.1, format="csr", dtype=np.float32,
                  random_state=np.random.default_rng(0))
    p = str(tmp_path / "t.mtx")
    tio.save_mtx(tsm.CSR.from_scipy(m), p)
    lines = open(p).read().splitlines(keepends=True)
    with open(p, "w") as fh:
        fh.writelines(lines[: len(lines) // 2])
    with pytest.raises(ValueError, match="truncated|entries"):
        tio.load_mtx(p)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_save_mtx_round_trips_through_both_packages(dtype, tmp_path):
    jsm, jio, _ = jax_ref()
    m = sp.random(60, 45, 0.15, format="csr", dtype=np.float64,
                  random_state=np.random.default_rng(1)).astype(dtype)
    m.data[3] = 0.0                                    # a stored zero survives
    tp, jp = str(tmp_path / "port.mtx"), str(tmp_path / "jax.mtx")
    tio.save_mtx(tsm.CSR.from_scipy(m), tp)
    jio.save_mtx(jsm.CSR.from_scipy(m), jp)
    assert open(tp).read() == open(jp).read()
    assert_csr_equal(tio.load_mtx(jp, dtype=dtype), jio.load_mtx(tp, dtype=dtype))
    back = tio.load_mtx(tp, dtype=dtype)
    assert back.n_non_zero_entries() == m.nnz
    np.testing.assert_array_equal(back.host("data"), m.data)
    np.testing.assert_array_equal(sp.csr_matrix(sio.mmread(tp)).toarray().astype(dtype),
                                  m.toarray())


def test_fallbacks_without_the_native_library(tmp_path, monkeypatch):
    """Without the C++ library: save_mtx's numpy formatter and load_mtx's
    numpy reader give the same matrix (9 significant digits keep f32)."""
    from sparsemat_tpu_torch import native

    def unavailable(*a, **k):
        raise ImportError("native library unavailable")

    m = sp.random(40, 30, 0.2, format="csr", dtype=np.float32,
                  random_state=np.random.default_rng(3))
    monkeypatch.setattr(native, "write_mtx_native", unavailable)
    monkeypatch.setattr(native, "parse_mtx_native", unavailable)
    p = str(tmp_path / "fallback.mtx")
    tio.save_mtx(tsm.CSR.from_scipy(m), p)
    back = tio.load_mtx(p)
    assert tio.last_mtx_parser == "numpy"
    np.testing.assert_array_equal(back.todense().numpy(), m.toarray())


def test_save_mtx_of_other_formats(tmp_path):
    _, jio, _ = jax_ref()
    m = sp.random(200, 200, 0.03, format="csr", dtype=np.float32,
                  random_state=np.random.default_rng(2))
    rs = tsm.CSR.from_scipy(m).to_route()
    p = str(tmp_path / "route.mtx")
    tio.save_mtx(rs, p)
    assert_csr_equal(tio.load_mtx(p), jio.load_mtx(p))
    np.testing.assert_array_equal(tio.load_mtx(p).todense().numpy(), m.toarray())


def test_rendering_equals_reference(tmp_path):
    jsm, jio, _ = jax_ref()
    m = sp.csr_matrix(np.array([[0, 2.24, 4.12], [1.5, 0, 0], [0, 0, 0],
                                [0, 0, -3.0]], np.float32))
    for tm, jm in ((tsm.CSR.from_scipy(m), jsm.CSR.from_scipy(m)),
                   (tio.load_mtx(os.path.join(DATA, "fem_p1_8x8.mtx")),
                    jio.load_mtx(os.path.join(DATA, "fem_p1_8x8.mtx")))):
        assert tio.to_string_row(tm, 0) == jio.to_string_row(jm, 0)
        assert tio.to_string(tm) == jio.to_string(jm)
        tio.to_pbm(tm, str(tmp_path / "t.pbm"))
        jio.to_pbm(jm, str(tmp_path / "j.pbm"))
        assert open(tmp_path / "t.pbm").read() == open(tmp_path / "j.pbm").read()
    assert tio.to_string_row(tsm.CSR.from_scipy(m), 0) == "0 2.24 4.12 "


# -- checkpoints -------------------------------------------------------------------

def random_matrix(n=48, density=0.15, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, n)).astype(np.float32)
    dense[rng.random((n, n)) >= density] = 0
    return sp.csr_matrix(dense), dense


def freeze(pkg, m, fmt):
    csr = pkg.CSR.from_scipy(m)
    return csr if fmt == "csr" else getattr(csr, f"to_{fmt}")()


def arrays_of(v, key="", out=None):
    """Every array of a format (either package's), keyed as checkpoints
    key them (``parts.0.vals``), with static metadata left out."""
    out = {} if out is None else out
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        for f in dataclasses.fields(v):
            arrays_of(getattr(v, f.name), f"{key}{f.name}" if not key else f"{key}.{f.name}",
                      out)
    elif isinstance(v, (tuple, list)):
        for i, e in enumerate(v):
            arrays_of(e, f"{key}.{i}", out)
    elif isinstance(v, torch.Tensor):
        out[key] = v.cpu().numpy()
    elif hasattr(v, "shape") and hasattr(v, "dtype") and not isinstance(v, np.generic):
        out[key] = np.asarray(v)
    return out


def assert_same_matrix(tmat, jmat):
    assert type(tmat).__name__ == type(jmat).__name__
    assert tmat.shape == tuple(jmat.shape)
    want = {k: a for k, a in arrays_of(jmat).items() if k != "tdata"}
    got = arrays_of(tmat)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    if hasattr(jmat, "offsets"):
        assert tmat.offsets == tuple(jmat.offsets)
    for tp, jp in zip(getattr(tmat, "parts", ()), getattr(jmat, "parts", ())):
        assert (tp.block_ids, tp.g4, tp.lidx_pack) == (tuple(jp.block_ids), jp.g4, jp.lidx_pack)


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_loads_reference_checkpoints(fmt, tmp_path):
    import jax.numpy as jnp

    jsm, _, jck = jax_ref()
    m, dense = random_matrix()
    jmat = freeze(jsm, m, fmt)
    p = str(tmp_path / f"{fmt}.npz")
    jck.save_matrix(p, jmat)
    back = tck.load_matrix(p)
    assert_same_matrix(back, jmat)
    x = np.random.default_rng(1).standard_normal(48).astype(np.float32)
    assert rel_err(tsm.spmv(back, torch.from_numpy(x)), jsm.spmv(jmat, jnp.asarray(x))) < 1e-5
    np.testing.assert_allclose(back.todense().numpy(), dense, rtol=1e-6)


@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_loads_port_checkpoints(fmt, tmp_path):
    import jax.numpy as jnp

    jsm, _, jck = jax_ref()
    m, dense = random_matrix(seed=2)
    tmat = freeze(tsm, m, fmt)
    p = str(tmp_path / f"{fmt}.npz")
    tck.save_matrix(p, tmat)
    back = jck.load_matrix(p)
    assert_same_matrix(tmat, back)
    if fmt == "dia":
        assert back.tdata is None
    x = np.random.default_rng(3).standard_normal(48).astype(np.float32)
    assert rel_err(jsm.spmv(back, jnp.asarray(x)), tsm.spmv(tmat, torch.from_numpy(x))) < 1e-5
    np.testing.assert_allclose(np.asarray(back.todense()), dense, rtol=1e-6)


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_round_trip_keeps_the_host_arrays(fmt, tmp_path):
    m, _ = random_matrix(seed=4)
    tmat = freeze(tsm, m, fmt)
    p = str(tmp_path / f"{fmt}.npz")
    tck.save_matrix(p, tmat)
    back = tck.load_matrix(p, device="cpu")
    assert type(back) is type(tmat)
    got, want = arrays_of(back), arrays_of(tmat)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(48).astype(np.float32))
    assert torch.equal(tsm.spmv(back, x), tsm.spmv(tmat, x))
    if fmt in ("csr", "route"):
        assert back.__dict__.get("_host_cache")        # no device read-back later


def test_version_1_flat_files_load_in_both_packages(tmp_path):
    jsm, _, jck = jax_ref()
    m, dense = random_matrix(seed=6)
    csr = tsm.CSR.from_scipy(m)
    header = json.dumps({"format": "CSR", "static": {"shape": list(csr.shape)}})
    p = str(tmp_path / "v1.npz")
    np.savez(p, __header__=np.frombuffer(header.encode(), np.uint8),
             **{f: getattr(csr, f).numpy() for f in CSR_ARRAYS})
    back = tck.load_matrix(p)
    assert isinstance(back, tsm.CSR)
    assert_csr_equal(back, jck.load_matrix(p))
    np.testing.assert_allclose(back.todense().numpy(), dense, rtol=1e-6)


@pytest.mark.parametrize("fmt", ["sell", "slab_stream"])
def test_an_unported_format_raises_and_names_it(fmt, tmp_path):
    """Every format of the JAX package is ported now: a file whose header
    names a format the port does not have (here a renamed one) raises."""
    jsm, _, jck = jax_ref()
    m, _ = random_matrix(seed=7)
    jmat = freeze(jsm, m, fmt)
    p = str(tmp_path / f"{fmt}.npz")
    jck.save_matrix(p, jmat)
    with np.load(p) as z:
        arrays = dict(z)
    header = json.loads(bytes(arrays.pop("__header__")).decode())
    name = "Unported" + type(jmat).__name__
    header["root"]["format"] = name
    np.savez(p, __header__=np.frombuffer(json.dumps(header).encode(), np.uint8), **arrays)
    with pytest.raises(ValueError, match=name):
        tck.load_matrix(p)


def test_save_matrix_rejects_what_is_not_a_format(tmp_path):
    b = tsm.SparseBuilder()
    b.add_to(0, 0, 1.0)
    with pytest.raises(TypeError):
        tck.save_matrix(str(tmp_path / "b.npz"), b)
    with pytest.raises(TypeError, match="bfloat16"):
        tck.save_matrix(str(tmp_path / "bf.npz"),
                        tsm.CSR.from_scipy(random_matrix()[0]).astype(torch.bfloat16))


def test_solve_checkpoints_resume_across_packages(tmp_path):
    """A BiCGStab solve stopped after 5 iterations in one package resumes in
    the other: both resumes take the same iterations to the same x."""
    import jax.numpy as jnp
    from sparsemat_tpu import solvers as js

    jsm, _, jck = jax_ref()
    rng = np.random.default_rng(8)
    n = 200
    m = (sp.random(n, n, 0.03, format="csr", random_state=rng)
         + sp.diags(np.full(n, 4.0))).tocsr()
    b = rng.standard_normal(n)
    tA, jA = tsm.CSR.from_scipy(m), jsm.CSR.from_scipy(m)
    x5, info5 = js.bicgstab(jA, jnp.asarray(b), tol=0.0, maxiter=5)
    jp, tp = str(tmp_path / "jax_state.npz"), str(tmp_path / "port_state.npz")
    jck.save_solve_state(jp, x5, info5)
    tx5, tinfo5 = ts.bicgstab(tA, torch.from_numpy(b), tol=0.0, maxiter=5)
    tck.save_solve_state(tp, tx5, tinfo5)
    tstate, jstate = tck.load_solve_state(jp), jck.load_solve_state(tp)
    assert tstate.iterations == jstate.iterations == 5
    assert tstate.residual_norm == pytest.approx(jstate.residual_norm, rel=1e-12)
    xt, it = tck.resume(ts.bicgstab, tA, torch.from_numpy(b), tstate, tol=1e-10)
    xj, ij = jck.resume(js.bicgstab, jA, jnp.asarray(b), jstate, tol=1e-10)
    assert bool(it.converged) and bool(ij.converged)
    assert int(it.iterations) == int(ij.iterations) > 5
    assert rel_err(xt, xj) < 1e-10


def test_solve_state_defaults(tmp_path):
    p = str(tmp_path / "s.npz")
    tck.save_solve_state(p, torch.zeros(4))
    s = tck.load_solve_state(p)
    assert s.iterations == 0 and np.isinf(s.residual_norm)
