"""The port's host partitions of the row-partitioned formats against the
JAX package's global arrays, and ``PartitionedBuilder`` against the JAX
one, in one process with no process group.

``parallel.dist.partition_*`` is a pure numpy function of the frozen
matrix and the block count; the JAX side distributes the same matrix over
``parallel.make_mesh(k)`` of the conftest's 8 virtual CPU devices, and
every array must be equal, dtype included, at 1, 2, 4 and 8 blocks, on the
matrices of ``tests/test_dist.py`` (``tests/_dist_cases.py``).  Static
fields (``hop_m``, ``rpb``, ``halo_windows``, ``local_windows``,
``buckets``) and ``exchange_bytes_per_spmv`` are equal too.  Last,
``interop.from_reference`` carries each format's JAX arrays into the port
at a world of one rank (gloo, an in-memory store), where its part must
equal the port's own ``distribute_*`` and its SpMV the JAX one's (f64 to
1e-12 relative to max |y|, f32 to 1e-5).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _dist_cases as cases
from _torch_cpu import LazyModule, port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import interop
from sparsemat_tpu_torch import parallel as tpar
from sparsemat_tpu_torch.parallel import dist as tdist

jsm = LazyModule("sparsemat_tpu")
jpar = LazyModule("sparsemat_tpu.parallel")

BLOCKS = (1, 2, 4, 8)


def _equal(got, want, what):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)


def _both(name):
    m = cases.MATRICES[name]()
    return m, tsm.CSR.from_scipy(m, device="cpu"), jsm.CSR.from_scipy(m)


# -- the host partitions -----------------------------------------------------------

@pytest.mark.parametrize("k", BLOCKS)
@pytest.mark.parametrize("name", cases.BANDED)
def test_partition_dia_equals_reference(name, k):
    _, tcsr, jcsr = _both(name)
    jd = jpar.distribute_dia(jcsr.to_dia(), jpar.make_mesh(k))
    got = tdist.partition_dia(tcsr.to_dia(), k)
    _equal(got["data"], jd.data, f"{name} data")
    assert tcsr.to_dia().offsets == jd.offsets


@pytest.mark.parametrize("fmt", ["csr", "ell"])
@pytest.mark.parametrize("k", BLOCKS)
@pytest.mark.parametrize("name", ["band3", "uneven237", "poisson2d", "stencil27", "skewed",
                                  "random300", "random1000"])
def test_partition_csr_equals_reference(name, k, fmt):
    _, tcsr, jcsr = _both(name)
    jd = jpar.distribute_csr(jcsr, jpar.make_mesh(k), format=fmt)
    got = tdist.partition_csr(tcsr, k, fmt)
    fields = ("cols", "vals") if fmt == "ell" else ("indptr", "indices", "data", "local_rows")
    assert set(got) == set(fields)
    for f in fields:
        _equal(got[f], getattr(jd, f), f"{name} {f}")


@pytest.mark.parametrize("k", BLOCKS)
@pytest.mark.parametrize("name", ["subset257", "skewed", "band40", "uneven237", "random300",
                                  "random1000"])
def test_partition_csr_subset_equals_reference(name, k):
    _, tcsr, jcsr = _both(name)
    jd = jpar.distribute_csr_subset(jcsr, jpar.make_mesh(k))
    got = tdist.partition_csr_subset(tcsr, k)
    assert got["hop_m"] == jd.hop_m and got["rpb"] == jd.rpb
    assert len(got["send_idx"]) == len(jd.send_idx) == k - 1
    for hop, (g, w) in enumerate(zip(got["send_idx"], jd.send_idx)):
        _equal(g, w, f"{name} send_idx[{hop}]")
    for f in ("indices", "data", "local_rows"):
        _equal(got[f], getattr(jd, f), f"{name} {f}")


@pytest.mark.parametrize("k", BLOCKS)
@pytest.mark.parametrize("name", ["scattered", "uneven_slab", "random1000", "poisson2d", "band130"])
def test_partition_slab_equals_reference(name, k):
    _, tcsr, jcsr = _both(name)
    jd = jpar.distribute_slab(jcsr, jpar.make_mesh(k), rb=128)
    got = tdist.partition_slab(tcsr, k, rb=128)
    for f in ("vals", "lidx", "win_lo"):
        _equal(got[f], getattr(jd, f), f"{name} {f}")
    assert got["buckets"] == jd.buckets
    assert got["halo_windows"] == jd.halo_windows
    assert got["local_windows"] == jd.local_windows


def test_partition_slab_default_row_block():
    _, tcsr, jcsr = _both("scattered")
    jd = jpar.distribute_slab(jcsr, jpar.make_mesh(4))
    got = tdist.partition_slab(tcsr, 4)
    _equal(got["vals"], jd.vals, "vals")
    assert got["local_windows"] == jd.local_windows


def test_partition_csr_refuses_unknown_format():
    with pytest.raises(ValueError, match="format"):
        tdist.partition_csr(tsm.CSR.from_scipy(cases.poisson1d(16), device="cpu"), 2, "bsr")


# -- a world of one: from_reference and the local parts ------------------------------

@pytest.fixture(scope="module")
def mesh1():
    """A mesh of one rank on a gloo world of one, torn down after the
    file's tests."""
    started = not dist.is_initialized()
    mesh = tpar.make_mesh(1, device="cpu")
    yield mesh
    if started:
        dist.destroy_process_group()


def _jax_y(jd, jmesh, x):
    return np.asarray(jd.unpad(jd.matvec(jd.padded_vector(x, jmesh), jmesh)))


def _port_y(td, mesh, x):
    return td.unpad(td.matvec(td.padded_vector(x, mesh), mesh)).full_tensor().numpy()


def _close(got, want, dtype):
    tol = 1e-12 if dtype == np.float64 else 1e-5
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got.astype(np.float64) - want).max() <= tol * scale


def _jax_fields(jd, names):
    out = {}
    for f in names:
        v = getattr(jd, f)
        out[f] = tuple(np.asarray(a) for a in v) if f == "send_idx" else (
            v if isinstance(v, (int, tuple)) else np.asarray(v))
    return out


FROM_REF = {
    "dist_dia": ("band3", lambda c, m: c.to_dia(), "distribute_dia", ("data",)),
    "dist_csr": ("random300", lambda c, m: c, "distribute_csr", ("indptr", "indices", "data",
                                                                 "local_rows")),
    "dist_ell": ("random300", lambda c, m: c, "distribute_csr", ("cols", "vals")),
    "dist_csr_subset": ("subset257", lambda c, m: c, "distribute_csr_subset",
                        ("send_idx", "indices", "data", "local_rows", "hop_m", "rpb")),
    "dist_slab": ("scattered", lambda c, m: c, "distribute_slab",
                  ("vals", "lidx", "win_lo", "buckets", "halo_windows", "local_windows")),
}


@pytest.mark.parametrize("fmt", sorted(FROM_REF))
def test_from_reference_round_trip(mesh1, fmt):
    name, freeze, fn, fields = FROM_REF[fmt]
    m, tcsr, jcsr = _both(name)
    jmesh = jpar.make_mesh(1)
    kw = {"format": "ell"} if fmt == "dist_ell" else {"rb": 128} if fmt == "dist_slab" else {}
    jd = getattr(jpar, fn)(freeze(jcsr, jmesh), jmesh, **kw)
    mine = getattr(tpar, fn)(freeze(tcsr, mesh1), mesh1, **kw)
    got = interop.from_reference(_jax_fields(jd, fields), format=fmt, shape=jd.shape,
                                 offsets=getattr(jd, "offsets", None), mesh=mesh1)
    assert type(got) is type(mine) and got.shape == mine.shape
    for f in fields:
        a, b = getattr(got, f), getattr(mine, f)
        if f == "send_idx":
            assert len(a) == len(b) == 0
        elif isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f
    x = np.random.default_rng(3).standard_normal(m.shape[0]).astype(m.dtype)
    want = _jax_y(jd, jmesh, x)
    _close(_port_y(got, mesh1, x), want, m.dtype)
    _close(_port_y(mine, mesh1, x), want, m.dtype)


def test_from_reference_needs_a_mesh_and_its_fields(mesh1):
    data = np.zeros((1, 3, 8), np.float32)
    with pytest.raises(ValueError, match="mesh"):
        interop.from_reference({"data": data}, format="dist_dia", shape=(8, 8),
                               offsets=(-1, 0, 1))
    with pytest.raises(ValueError, match="missing"):
        interop.from_reference({}, format="dist_csr", shape=(8, 8), mesh=mesh1)
    with pytest.raises(ValueError, match="blocks"):
        interop.from_reference({"data": np.zeros((2, 3, 4), np.float32)}, format="dist_dia",
                               shape=(8, 8), offsets=(-1, 0, 1), mesh=mesh1)


def test_exchange_bytes_per_spmv_equals_reference(mesh1):
    _, tcsr, jcsr = _both("skewed")
    for k in (1, 8):
        jd = jpar.distribute_csr_subset(jcsr, jpar.make_mesh(k))
        got = tdist.partition_csr_subset(tcsr, k)
        # the port's formula on the partition's static fields, at k blocks
        assert k * sum(got["hop_m"]) * 4 == jd.exchange_bytes_per_spmv()
    mine = tpar.distribute_csr_subset(tcsr, mesh1)
    jd1 = jpar.distribute_csr_subset(jcsr, jpar.make_mesh(1))
    assert mine.exchange_bytes_per_spmv() == jd1.exchange_bytes_per_spmv()


def test_world_of_one_mesh(mesh1):
    assert mesh1.mesh_dim_names == ("rows",) and mesh1.size() == 1
    assert tpar.process_info() == {"process_index": 0, "process_count": 1,
                                   "local_devices": 1, "global_devices": 1}
    assert tpar.row_sharding(mesh1)[0].dim == 0
    with pytest.raises(ValueError, match="ranks"):
        tpar.make_mesh(2, device="cpu")


# -- PartitionedBuilder ------------------------------------------------------------------

def _inserts(seed=0, n=200, n_rows=97, n_cols=61):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_rows, n), rng.integers(0, n_cols, n),
            rng.standard_normal(n))


@pytest.mark.parametrize("n_blocks,max_rows", [(1, 97), (4, 97), (7, 50), (3, 200)])
def test_partitioned_builder_matches_reference(n_blocks, max_rows):
    tb = tsm.PartitionedBuilder(n_blocks, max_rows, dtype=torch.float64)
    jb = jsm.PartitionedBuilder(n_blocks, max_rows, dtype=np.float64)
    sb = tsm.SparseBuilder(dtype=torch.float64)
    for i, j, v in zip(*_inserts()):
        tb.add_to(i, j, v)
        jb.add_to(i, j, v)
        sb.add_to(i, j, v)
    tb[3, 5] = 2.5
    jb[3, 5] = 2.5
    sb[3, 5] = 2.5
    assert tb.shape == jb.shape and tb.nnz == jb.nnz and tb.density() == jb.density()
    assert tb.rows_per_block == jb.rows_per_block
    for i in (0, 3, 48, 96, 199):
        assert tb._route(i) == jb._route(i)
        assert list(tb.iter_row(i)) == [(c, v) for c, v in jb.iter_row(i)]
    assert tb[3, 5] == jb[3, 5] == 2.5 and tb.get(1000, 0) == 0.0
    assert sorted(tb) == sorted((int(i), int(j), float(v)) for i, j, v in jb)
    tc, jc = tb.to_coo(device="cpu"), jb.to_coo()
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    assert tc.shape == jc.shape and tc.canonical
    csr, ref = tb.to_csr(device="cpu"), sb.to_csr(device="cpu")
    for f in ("indptr", "indices", "data", "row_ids"):
        assert torch.equal(getattr(csr, f), getattr(ref, f)), f
    x = np.random.default_rng(1).standard_normal(csr.shape[1])
    np.testing.assert_allclose(tb.mvp(torch.from_numpy(x)).numpy(), np.asarray(jb.mvp(x)),
                               rtol=1e-12, atol=1e-12)


def test_partitioned_builder_routes_past_the_last_block_to_it():
    tb = tsm.PartitionedBuilder(3, 10)
    tb.add_to(9, 0, 1.0)            # rows 6..9 go to the last block
    assert tb.blocks[2].nnz == 1 and tb._route(9) == (2, 3)
    assert tb.shape == (10, 1)
    with pytest.raises(ValueError):
        tsm.PartitionedBuilder(0, 10)
    with pytest.raises(ValueError):
        tsm.PartitionedBuilder(5, 4)
    assert tsm.PartitionedBuilder.with_sub_matrices(2, 8).rows_per_block == 4
