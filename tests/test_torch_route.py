"""The port's RouteStream against the JAX package's on the same inputs: the
freeze gives the same 17 arrays bit for bit (it is the same host numpy
program), the edge colouring is the same and proper, the plain versions
match ``route_spmv_xla`` and the Pallas kernels in interpret mode, the
layout holds the invariants the freeze gives (one real product per staging
slot, each y window's staging rows contiguous), and the whole
scattered-matrix slice (MatrixMarket → RouteStream → solvers) agrees with
the JAX package's.  On a CUDA card, the merge-path kernel matches its
plain version and, bitwise, the walk of its plan
(``tests/test_torch_route_merge.py`` holds the walk to the JAX package).

Tolerances: relative to max|reference|, 1e-5 in f32 (the plain reduce
takes its prefix sum as a matrix product, whose summation order differs
from XLA's), 1e-12 in f64.  f32 operands are passed explicitly, because
``tests/conftest.py`` turns on JAX's x64 mode.  The JAX package is imported
inside the tests, so the CUDA tests of this file also run on a machine
without JAX (``-m cuda --noconftest``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import plan_launches
from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import io as tio
from sparsemat_tpu_torch import matgen, solvers
from sparsemat_tpu_torch.formats import route as troute
from sparsemat_tpu_torch.interop import from_reference
from sparsemat_tpu_torch.kernels import _rowgroup as rg
from sparsemat_tpu_torch.kernels import route as kr

ARRAYS = troute.ARRAYS


def rand_scatter(n, dens, seed, with_zero=False):
    """tests/test_route.py's matrices: uniform scatter plus the identity."""
    m = sp.random(n, n, dens, random_state=seed, format="csr").astype(np.float32)
    m.data = (m.data * 10 - 5).astype(np.float32)
    m = (m + sp.eye(n, dtype=np.float32, format="csr")).tocsr()
    if with_zero:
        m.data[0] = 0.0              # a stored entry whose value is zero
    m.sort_indices()
    return m


def zipf_rows():
    """Power-law row degrees, with rows of more than 128 entries."""
    rng = np.random.default_rng(5)
    n = 700
    deg = np.minimum(rng.zipf(1.7, n), 300)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    v = rng.standard_normal(src.size).astype(np.float32)
    m = sp.coo_matrix((v, (src, dst)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    return m


def rect():
    m = rand_scatter(300, 0.01, 9)[:, :250].tocsr()
    m.sort_indices()
    return m


MATRICES = {
    "n300": lambda: rand_scatter(300, 0.01, 1),
    "n1000": lambda: rand_scatter(1000, 0.004, 2),
    "n257": lambda: rand_scatter(257, 0.03, 3),
    "n64": lambda: rand_scatter(64, 0.2, 4),
    "zipf": zipf_rows,
    "stored_zero": lambda: rand_scatter(200, 0.02, 7, with_zero=True),
    "rect_300x250": rect,
    "empty_5x7": lambda: sp.csr_matrix((5, 7), dtype=np.float32),
    "tiny_3x3": lambda: sp.csr_matrix(np.array([[1.0, 0, 2.0], [0, 0, 0], [0, 3.0, 0]],
                                               np.float32)),
    # 2 splits: full supertiles whose products land in two regions
    "two_splits": lambda: sp.random(600, 128, 0.5, format="csr", dtype=np.float32,
                                    random_state=np.random.default_rng(0)),
}


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if not b.size:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_ref():
    jsm = pytest.importorskip("sparsemat_tpu")
    from sparsemat_tpu.kernels import route as jkr

    return jsm, jkr


def both(m):
    jsm, _ = jax_ref()
    return jsm.CSR.from_scipy(m).to_route(), tsm.CSR.from_scipy(m).to_route()


def assert_arrays_equal(jrs, trs):
    assert trs.shape == tuple(jrs.shape)
    for f in ARRAYS:
        a = np.asarray(getattr(jrs, f))
        b = getattr(trs, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)


# -- the freeze ------------------------------------------------------------------

@pytest.mark.parametrize("name", MATRICES)
def test_freeze_equals_reference(name):
    m = MATRICES[name]()
    jrs, trs = both(m)
    assert_arrays_equal(jrs, trs)
    assert (trs.nse, trs.n_sup, trs.n_splits, trs.n_regions) == \
        (jrs.nse, jrs.n_sup, jrs.n_splits, jrs.n_regions)
    assert trs.n_non_zero_entries() == int(jrs.n_non_zero_entries()) == m.nnz
    assert trs.spmv_traffic_bytes() == jrs.spmv_traffic_bytes()
    assert trs.vmem_resident_bytes() == jrs.vmem_resident_bytes()
    assert trs.smem_prefetch_bytes() == jrs.smem_prefetch_bytes()
    assert (trs.x_windows(), trs.y_windows()) == (jrs.x_windows(), jrs.y_windows())
    assert trs.fill_ratio() == pytest.approx(jrs.fill_ratio(), rel=1e-12)
    assert trs.index_dtype == torch.int32 and trs.data is trs.a_vals
    if name == "two_splits":
        assert trs.n_splits >= 2


def test_freeze_of_f64_values_and_the_circuit_surrogate():
    m = matgen.circuit_scatter(n=4000, seed=2).astype(np.float64)
    jrs, trs = both(m)
    assert_arrays_equal(jrs, trs)
    assert trs.dtype == torch.float64 and trs.m1.dtype == torch.float64


def test_euler_colouring_equals_reference_and_is_proper():
    from sparsemat_tpu.formats.route import _euler_color_128 as jcolor

    jax_ref()
    rng = np.random.default_rng(0)
    inst = np.repeat(np.arange(3), 128 * 128)
    src = np.tile(np.repeat(np.arange(128), 128), 3)
    dst = np.concatenate([rng.permutation(128) for _ in range(3 * 128)])
    sh = rng.permutation(inst.size)
    col = troute._euler_color_128(inst[sh], src[sh], dst[sh])
    np.testing.assert_array_equal(col, jcolor(inst[sh], src[sh], dst[sh]))
    a = inst[sh] * 128 * 128 + src[sh] * 128 + col
    b = inst[sh] * 128 * 128 + dst[sh] * 128 + col
    assert np.unique(a).size == a.size and np.unique(b).size == b.size
    assert col.min() >= 0 and col.max() < 128


# -- the plain versions ----------------------------------------------------------

@pytest.mark.parametrize("name", MATRICES)
def test_plain_versions_match_xla_oracle(name):
    import jax.numpy as jnp

    _, jkr = jax_ref()
    m = MATRICES[name]()
    rng = np.random.default_rng(3)
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        md = m.astype(dt)
        jrs, trs = both(md)
        x = rng.standard_normal(m.shape[1]).astype(dt)
        want = np.asarray(jkr.route_spmv_xla(jrs, jnp.asarray(x)))
        xt = torch.from_numpy(x)
        staging = kr.route_gather_ref(trs, xt)
        assert staging.shape == (kr.staging_rows(trs), 128)
        y = kr.route_reduce_ref(trs, staging)
        assert y.dtype == xt.dtype and y.shape == (m.shape[0],)
        assert torch.equal(kr.route_spmv_ref(trs, xt), y)
        assert rel_err(y, want) < tol
        assert rel_err(y, md @ x) < tol


@pytest.mark.parametrize("name", ["zipf", "two_splits"])
def test_plain_versions_match_pallas_interpret(name):
    import jax.numpy as jnp

    _, jkr = jax_ref()
    m = MATRICES[name]()
    jrs, trs = both(m)
    x = np.random.default_rng(4).standard_normal(m.shape[1]).astype(np.float32)
    staging_pl = np.array(jkr.route_gather_pallas(jrs, jnp.asarray(x), interpret=True))
    staging = kr.route_gather_ref(trs, torch.from_numpy(x))
    n = trs.n_regions * 128
    assert rel_err(staging[:n], staging_pl[:n]) < 1e-5
    want = jkr.route_reduce_pallas(jrs, jnp.asarray(staging_pl), interpret=True)
    assert rel_err(kr.route_reduce_ref(trs, torch.from_numpy(staging_pl)), want) < 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_values_match_xla_oracle(dtype):
    import jax.numpy as jnp

    jsm, jkr = jax_ref()
    m = MATRICES["zipf"]()
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jrs = jsm.CSR.from_scipy(m).astype(jdt).to_route()
    trs = tsm.CSR.from_scipy(m).astype(dtype).to_route()
    assert trs.dtype == dtype and trs.m1.dtype == dtype
    x = np.random.default_rng(6).standard_normal(m.shape[1]).astype(np.float32)
    want = jkr.route_spmv_xla(jrs, jnp.asarray(x).astype(jdt))
    got = tsm.spmv(trs, torch.from_numpy(x).to(dtype))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert rel_err(got, want) < 1e-5


# -- the invariants the freeze gives ------------------------------------------------

def replay_cuda_design(rs, x):
    """A gather/reduce pair that leans on the freeze's two invariants, step
    for step, in numpy (f64): each real product STORED into its staging
    slot (composed gather, no addition), then per y window its staging rows
    in order, each lane summing its segment directly, over 8 warps' rows
    added in warp order."""
    h = {k: rs.host(k).astype(np.float64 if k in troute.FLOAT_ARRAYS else np.int64)
         for k in ARRAYS}
    n_rows, n_cols = rs.shape
    n_sup, n_spl = rs.n_sup, rs.n_splits
    cols = h["a_win"][:, None] * 128 + h["a_lidx"]
    xv = np.zeros(cols.shape)
    inside = cols < n_cols
    xv[inside] = x[cols[inside]]
    prod = (h["a_vals"] * xv).reshape(n_sup, 128, 128)
    staging = np.zeros((kr.staging_rows(rs), 128))
    written = np.zeros(staging.shape, int)
    j = np.arange(128)[:, None]
    lanes = np.broadcast_to(np.arange(128)[None, :], (128, 128))
    for t in range(n_sup):
        for s_ in range(n_spl):
            c = h["p3"][t, s_]
            src = h["p2"][t, s_][c, j]
            m1 = h["m1"][t, s_][src, c]
            real = m1 != 0
            rows = np.broadcast_to(h["touch"][t, s_][:, None], (128, 128))
            staging[rows[real], lanes[real]] = (m1 * prod[t][src, h["p1"][t, s_][src, c]])[real]
            written[rows[real], lanes[real]] += 1
    assert written.max(initial=0) <= 1            # one real product per slot
    lo, hi = kr.window_rows(rs)
    y = np.zeros(rs.y_windows() * 128)
    for w in range(rs.y_windows()):
        part = np.zeros((8, 128))
        for g in range(lo[w], hi[w]):
            reg, jj = divmod(g, 128)
            c = h["q3"][reg, jj]
            src = h["q2"][reg][c, jj]
            row = staging[reg * 128 + src, h["q1"][reg][src, c]]
            for r in np.nonzero(h["segmask"][reg, jj])[0]:
                first = h["ppos"][reg, jj, r] + 1 if h["pmask"][reg, jj, r] else 0
                part[(g - lo[w]) % 8, r] += row[first:h["lpos"][reg, jj, r] + 1].sum()
        y[w * 128:(w + 1) * 128] = part.sum(axis=0)
    return staging, y[:n_rows]


@pytest.mark.parametrize("name", MATRICES)
def test_layout_holds_the_cuda_kernels_invariants(name):
    import jax.numpy as jnp

    _, jkr = jax_ref()
    m = MATRICES[name]().astype(np.float64)
    jrs, trs = both(m)
    owners = kr.slot_owners(trs)
    assert owners.size == m.nnz and np.unique(owners).size == owners.size
    lo, hi = kr.window_rows(trs)
    assert np.all(lo <= hi)
    # every real staging row in reduce layout belongs to exactly one window
    assert int((hi - lo).sum()) == int((trs.host("wrow") != trs.y_windows()).sum())
    # dummy q1 slots read lane 127, empty on every arrival row with a deficit
    x = np.random.default_rng(7).standard_normal(m.shape[1])
    staging, y = replay_cuda_design(trs, x)
    plain = kr.route_gather_ref(trs, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(staging, plain)
    assert rel_err(y, jkr.route_spmv_xla(jrs, jnp.asarray(x))) < 1e-12


def test_invariant_checks_catch_a_broken_layout():
    m = MATRICES["n1000"]()
    rs = tsm.CSR.from_scipy(m).to_route()
    wrow = rs.host("wrow").copy()
    g = np.nonzero(wrow.reshape(-1) < rs.y_windows())[0]
    wrow.reshape(-1)[[g[0], g[-1]]] = wrow.reshape(-1)[[g[-1], g[0]]]
    arrays = {k: rs.host(k) for k in ARRAYS}
    broken = troute.RouteStream.from_host(dict(arrays, wrow=wrow), rs.shape)
    with pytest.raises(ValueError, match="contiguous"):
        kr.window_rows(broken)
    touch = rs.host("touch").copy()
    touch[0, 0, 1] = touch[0, 0, 0]          # two arrival rows onto one staging row
    owners = kr.slot_owners(troute.RouteStream.from_host(dict(arrays, touch=touch),
                                                         rs.shape))
    assert np.unique(owners).size < owners.size


# -- canonical views, structure, dispatch, interop ---------------------------------

@pytest.mark.parametrize("name", ["stored_zero", "rect_300x250", "empty_5x7", "zipf"])
def test_to_csr_round_trip(name):
    m = MATRICES[name]()
    rs = tsm.CSR.from_scipy(m).to_route()
    back = rs.to_csr()
    got = sp.csr_matrix((back.data.numpy(), back.indices.numpy(), back.indptr.numpy()),
                        shape=back.shape)
    assert back.shape == m.shape
    assert back.n_non_zero_entries() == rs.n_non_zero_entries() == m.nnz
    assert (got != m).nnz == 0
    np.testing.assert_array_equal(rs.todense().numpy(), m.toarray())
    assert rs.to_route() is rs


def test_scale_and_astype_keep_the_layout():
    m = MATRICES["zipf"]()
    rs = tsm.CSR.from_scipy(m).to_route()
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(m.shape[1]))
    assert rel_err(tsm.spmv(2.0 * rs, x.float()), 2 * (m @ x.numpy())) < 1e-5
    r64 = rs.astype(torch.float64)
    assert r64.dtype == torch.float64 and r64.pmask.dtype == torch.float64
    for f in ARRAYS:
        if f not in troute.FLOAT_ARRAYS:
            assert torch.equal(getattr(r64, f), getattr(rs, f)), f
    y = tsm.spmv(r64, x)
    assert y.dtype == torch.float64 and rel_err(y, m.astype(np.float64) @ x.numpy()) < 1e-6


def test_from_reference_route():
    import jax.numpy as jnp

    _, jkr = jax_ref()
    m = MATRICES["two_splits"]()
    jrs, _ = both(m)
    trs = from_reference({f: np.asarray(getattr(jrs, f)) for f in ARRAYS},
                         format="route", shape=jrs.shape)
    assert_arrays_equal(jrs, trs)
    x = np.random.default_rng(9).standard_normal(m.shape[1]).astype(np.float32)
    assert rel_err(tsm.spmv(trs, torch.from_numpy(x)),
                   jkr.route_spmv_xla(jrs, jnp.asarray(x))) < 1e-5
    with pytest.raises(ValueError, match="missing"):
        from_reference({"a_vals": np.zeros((128, 128))}, format="route", shape=(5, 5))


def test_spmv_dispatch_and_method():
    m = MATRICES["zipf"]()
    csr = tsm.CSR.from_scipy(m)
    rs = csr.to_route()
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(m.shape[1]).astype(np.float32))
    y = tsm.spmv(rs, x)
    assert torch.equal(y, kr.route_spmv_ref(rs, x))
    assert torch.equal(tsm.spmv(csr, x, method="route"), y)
    assert torch.equal(rs @ x, y) and torch.equal(rs.mvp(x), y)
    yd, d = tsm.spmv_dot(rs, x)
    assert torch.equal(yd, y) and float(d) == pytest.approx(float(x @ y), rel=1e-6)
    y3 = tsm.spmv_chain(rs, x, 3)
    assert rel_err(y3, m @ (m @ (m @ x.numpy()))) < 1e-5
    # the general-matrix method, ported since: a WELL freeze and its kernel
    assert rel_err(tsm.spmv(csr, x, method="well"), m @ x.numpy()) < 1e-5
    with pytest.raises(ValueError, match="unknown method"):
        tsm.spmv(csr, x, method="nope")


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    rs = tsm.CSR.from_scipy(MATRICES["n300"]()).to_route()
    x = torch.randn(300)
    rg.reset_launches()
    y = rs @ x
    assert torch.equal(y, kr.route_spmv_ref(rs, x))
    assert torch.equal(tsm.spmv(rs, x), y)
    assert rg.LAUNCHES == plan_launches({"route_spmv": 0, "route_spmm": 0})
    assert "_rowgroup_plan" not in rs.__dict__          # the plain version builds no plan


# -- the slice: MatrixMarket → RouteStream → solvers, in both packages --------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_circuit_slice_through_both_packages(dtype, tmp_path):
    """circuit_scatter → the port's save_mtx → load_mtx in both packages →
    to_route in both (arrays equal) → BiCGStab and Jacobi in both.  f64:
    equal iteration counts and x within 1e-10.  f32: x within 1e-4 relative
    and iteration counts within 1 (the packages' reductions round in other
    orders, which can move the stopping test by one iteration).

    BiCGStab is compared with the Jacobi preconditioner: unpreconditioned,
    it amplifies the last-bit differences of the two packages' dot products
    on this operator (whose diagonal spans ~3 decades) until the iterates
    differ by ~1e-8 after 56 steps.  The unpreconditioned solve is held to
    its true residual in each package instead."""
    import jax.numpy as jnp
    from sparsemat_tpu import io as jio
    from sparsemat_tpu import solvers as jsolvers

    jax_ref()
    m = matgen.circuit_scatter(n=3000, seed=1)
    path = str(tmp_path / "circuit.mtx")
    tio.save_mtx(tsm.CSR.from_scipy(m), path)
    tcsr = tio.load_mtx(path, dtype=dtype)
    assert tio.last_mtx_parser == "native"
    jcsr = jio.load_mtx(path, dtype=dtype)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(tcsr.host(f), np.asarray(getattr(jcsr, f)))
    trs, jrs = tcsr.to_route(), jcsr.to_route()
    assert_arrays_equal(jrs, trs)
    b = np.random.default_rng(11).standard_normal(m.shape[0]).astype(dtype)
    rtol = 1e-8 if dtype == np.float64 else 1e-5
    m64 = m.astype(np.float64)
    runs = {
        "bicgstab_jacobi": (
            lambda: solvers.bicgstab(trs, torch.from_numpy(b), tol=0.0, rtol=rtol, maxiter=2000,
                                     M=solvers.JacobiPreconditioner.from_matrix(trs)),
            lambda: jsolvers.bicgstab(jrs, jnp.asarray(b), tol=0.0, rtol=rtol, maxiter=2000,
                                      M=jsolvers.JacobiPreconditioner.from_matrix(jrs))),
        "jacobi": (
            lambda: solvers.jacobi(trs, torch.from_numpy(b), tol=0.0, rtol=rtol, maxiter=2000),
            lambda: jsolvers.jacobi(jrs, jnp.asarray(b), tol=0.0, rtol=rtol, maxiter=2000)),
        "bicgstab": (
            lambda: solvers.bicgstab(trs, torch.from_numpy(b), tol=0.0, rtol=rtol, maxiter=2000),
            lambda: jsolvers.bicgstab(jrs, jnp.asarray(b), tol=0.0, rtol=rtol, maxiter=2000)),
    }
    for name, (port, ref) in runs.items():
        (xt, it), (xj, ij) = port(), ref()
        assert bool(it.converged) and bool(ij.converged), name
        for x_ in (xt.double().numpy(), np.asarray(xj, np.float64)):
            assert np.linalg.norm(b - m64 @ x_) <= 10 * rtol * np.linalg.norm(b), name
        if name == "bicgstab":
            continue
        if dtype == np.float64:
            assert int(it.iterations) == int(ij.iterations), name
            assert rel_err(xt, xj) < 1e-10, name
        else:
            assert abs(int(it.iterations) - int(ij.iterations)) <= 1, name
            assert rel_err(xt, xj) < 1e-4, name


# -- the CUDA kernel against its plain version and its walk (needs a card) -------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("name", MATRICES)
def test_cuda_kernels_match_plain(cuda, dtype, name):
    """One launch per SpMV; the kernel against the plain table halves, and
    bitwise against the walk of its split at the default tile and at tiles
    of 8 and 16 items; reruns bitwise."""
    m = MATRICES[name]()
    rs = tsm.CSR.from_scipy(m, device=cuda).to_route().astype(dtype)
    x = torch.randn(m.shape[1], device=cuda)
    x = x.to(dtype) if dtype != torch.bfloat16 else x
    rg.reset_launches()
    y = tsm.spmv(rs, x)
    torch.cuda.synchronize()
    assert rg.LAUNCHES == plan_launches({"route_spmv": 1, "route_spmm": 0})
    y_ref = kr.route_spmv_ref(rs, x)
    assert y.dtype == y_ref.dtype and y.shape == (m.shape[0],)
    assert rel_err(y.cpu(), y_ref.cpu()) < TOL[dtype]
    plan = rg.plan_of(rs)
    assert plan.group == 1
    for split in (plan.merge, rg.MergeSplit(plan, 8), rg.MergeSplit(plan, 16)):
        got = y if split is plan.merge else kr.launch(plan, split, x)
        assert torch.equal(got, kr.route_spmv_walk(plan, split, x)), split.items
        assert rel_err(got.cpu(), y_ref.cpu()) < TOL[dtype]
    assert torch.equal(tsm.spmv(rs, x), y)            # reruns bitwise


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    rs = tsm.CSR.from_scipy(MATRICES["n300"](), device=cuda).to_route()
    with pytest.raises(ValueError):
        tsm.spmv(rs, torch.zeros(300))                    # vector on the CPU
    with pytest.raises(ValueError):
        tsm.spmv(rs, torch.zeros(301, device=cuda))       # wrong length
    with pytest.raises(TypeError):
        tsm.spmv(rs, torch.zeros(300, dtype=torch.int32, device=cuda))
    rg.reset_launches()
    with pytest.raises(ValueError):
        tsm.spmv(rs, torch.zeros(2, 150, device=cuda))    # not a vector
    assert rg.LAUNCHES == plan_launches({"route_spmv": 0, "route_spmm": 0})
