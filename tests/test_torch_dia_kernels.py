"""The port's DIA SpMV, its fused dot and chain, against the JAX package's
Pallas kernels run in interpret mode on the same inputs, and (on a CUDA
card) the port's CUDA kernels against their plain PyTorch versions.

Tolerances: relative to max|reference|, 1e-5 on y in f32 (the same
diagonal-order sum, rounded with and without fused multiply-add); 1e-4 on
the dot in f32 (a different summation order: per-block trees here, per-lane
partials there); 1e-12 in f64.  The JAX package is imported inside the
tests, so the CUDA tests of this file also run on a machine without JAX
(``-m cuda --noconftest``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch.kernels import dia as kd


def banded(n, offs, seed=0, scale=1.0, n_cols=None):
    rng = np.random.default_rng(seed)
    n_cols = n if n_cols is None else n_cols
    m = sp.diags([rng.standard_normal(n + n_cols) * scale for _ in offs], offs,
                 shape=(n, n_cols), format="csr")
    return m.astype(np.float32)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def ref():
    """The JAX package and its DIA kernels."""
    jsm = pytest.importorskip("sparsemat_tpu")
    from sparsemat_tpu.kernels import dia as jkd

    return jsm, jkd


def both(m, seed=1):
    """(JAX DIA, port DIA, x as numpy f32) for scipy matrix ``m``."""
    jsm, _ = ref()
    x = np.random.default_rng(seed).standard_normal(m.shape[1]).astype(np.float32)
    return jsm.CSR.from_scipy(m).to_dia(), tsm.CSR.from_scipy(m).to_dia(), x


# -- against the Pallas kernels (interpret mode) -------------------------------

@pytest.mark.parametrize("n,offs,chunk", [
    (5000, (-130, -1, 0, 1, 130), 2048),   # multi-chunk, unaligned tail
    (3000, (-2, 0, 2), 1 << 17),           # one chunk
    (1030, (-7, 0, 7), 1024),              # tiny
])
def test_spmv_matches_pallas_1d(n, offs, chunk):
    import jax.numpy as jnp

    _, jkd = ref()
    jd, td, x = both(banded(n, offs))
    want = jkd.dia_spmv_pallas(jd, jnp.asarray(x), chunk=chunk, interpret=True)
    got = tsm.spmv(td, torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert rel_err(got, want) < 1e-5


TILED_CASES = [
    (5000, (-64, -1, 0, 1, 64), 4096),       # 2 chunks, ±1 rolls
    (300, (-7, 0, 13), 1024),                # sub-lane offsets both signs
    (4096, (-1024, 0, 1024), 1024),          # 4 chunks, pure row shifts
    (2048, (-129, -127, 0, 127, 129), 1024),  # offsets straddling a lane
    (64 * 64, (-64, -1, 0, 1, 64), 1024),     # the 2-D Poisson offsets, s = 64
    (128 * 128, (-128, -1, 0, 1, 128), 4096),  # and s = 128
]


def _tiled(jkd, jd, x, C, with_dot):
    import jax.numpy as jnp

    h = max(abs(o) for o in jd.offsets)
    H = 1 << (max(h, 1024) - 1).bit_length()
    return jkd._dia_spmv_pallas_2d_impl(
        jd.tdata, jnp.asarray(x), offsets=tuple(jd.offsets), n_rows=jd.shape[0],
        H=H, C=C, with_dot=with_dot, interpret=True)


@pytest.mark.parametrize("n,offs,C", TILED_CASES)
def test_spmv_matches_pallas_2d(n, offs, C):
    _, jkd = ref()
    jd, td, x = both(banded(n, offs))
    want = _tiled(jkd, jd, x, C, with_dot=False)
    assert rel_err(tsm.spmv(td, torch.from_numpy(x)), want) < 1e-5


@pytest.mark.parametrize("n,offs,C", TILED_CASES)
def test_spmv_dot_matches_pallas_2d(n, offs, C):
    _, jkd = ref()
    jd, td, x = both(banded(n, offs))
    want_y, want_d = _tiled(jkd, jd, x, C, with_dot=True)
    y, d = tsm.spmv_dot(td, torch.from_numpy(x))
    assert rel_err(y, want_y) < 1e-5
    assert rel_err(float(d), float(want_d)) < 1e-4


@pytest.mark.parametrize("k", [1, 2, 5])
def test_spmv_chain_matches_pallas(k):
    import jax.numpy as jnp

    _, jkd = ref()
    jd, td, x = both(banded(300, (-3, -1, 0, 1, 3), scale=0.05))
    assert jkd.dia_chain_plan(jd) is not None
    want = jkd.dia_spmv_chain_pallas(jd, jnp.asarray(x), k, interpret=True)
    got = tsm.spmv_chain(td, torch.from_numpy(x), k)
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("op", ["spmv", "spmv_dot", "spmv_chain"])
def test_f64_matches_xla(op):
    import jax.numpy as jnp

    jsm, _ = ref()
    m = banded(2000, (-300, -1, 0, 1, 300), seed=4, scale=0.3).astype(np.float64)
    jd = jsm.CSR.from_scipy(m).to_dia()
    td = tsm.CSR.from_scipy(m).to_dia()
    assert td.dtype == torch.float64
    x = np.random.default_rng(5).standard_normal(2000)
    args = {"spmv": (), "spmv_dot": (), "spmv_chain": (3,)}[op]
    want = getattr(jsm, op)(jd, jnp.asarray(x, jnp.float64), *args)
    got = getattr(tsm, op)(td, torch.from_numpy(x), *args)
    for g, w in zip(got if op == "spmv_dot" else [got],
                    want if op == "spmv_dot" else [want]):
        assert rel_err(g, w) < 1e-12


def test_rectangular_spmv_matches_xla():
    import jax.numpy as jnp

    jsm, _ = ref()
    m = banded(700, (-5, 0, 3, 40), seed=6, n_cols=900)
    jd, td, x = both(m)
    want = jsm.formats.dia.dia_spmv(jd, jnp.asarray(x))
    assert rel_err(tsm.spmv(td, torch.from_numpy(x)), want) < 1e-5


def test_dia_spmm_matches_xla():
    import jax.numpy as jnp

    jsm, _ = ref()
    jd, td, _ = both(banded(500, (-9, 0, 2)))
    B = np.random.default_rng(8).standard_normal((500, 3)).astype(np.float32)
    want = jsm.formats.dia.dia_spmm(jd, jnp.asarray(B))
    got = tsm.formats.dia.dia_spmm(td, torch.from_numpy(B))
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("op", ["spmv", "spmv_dot", "spmv_chain"])
@pytest.mark.parametrize("dt_mat,dt_x", [("bfloat16", "bfloat16"), ("float16", "float16"),
                                         ("float32", "float64"), ("bfloat16", "float32")])
def test_low_precision_and_mixed_dia_matches_reference(op, dt_mat, dt_x):
    """bf16/f16 and mixed-dtype DIA ops against ``sparsemat_tpu`` on the same
    values: the same result dtype (bf16/f16 accumulate in f32), values
    within 1e-5 of max|ref| (1e-12 for f64: both widen the same values)."""
    import jax.numpy as jnp

    jsm, _ = ref()
    m = banded(3000, (-300, -1, 0, 1, 300), seed=11, scale=0.3)
    x = np.random.default_rng(12).standard_normal(3000).astype(np.float32)
    jd = jsm.CSR.from_scipy(m).to_dia().astype(getattr(jnp, dt_mat))
    td = tsm.CSR.from_scipy(m).to_dia().astype(getattr(torch, dt_mat))
    jx = jnp.asarray(x).astype(getattr(jnp, dt_x))
    tx = torch.from_numpy(x).to(getattr(torch, dt_x))
    args = (2,) if op == "spmv_chain" else ()
    want = getattr(jsm, op)(jd, jx, *args)
    got = getattr(tsm, op)(td, tx, *args)
    want = want if op == "spmv_dot" else [want]
    got = got if op == "spmv_dot" else [got]
    tol = 1e-12 if "float64" in (dt_mat, dt_x) else 1e-5
    for g, w in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        assert rel_err(g.float() if g.dtype == torch.bfloat16 else g, w) < tol


# -- the CSR/COO stream path ----------------------------------------------------

def test_csr_stream_matches_reference_and_reruns_bitwise():
    import jax.numpy as jnp

    jsm, _ = ref()
    m = sp.random(400, 300, density=0.05, random_state=3, format="csr",
                  dtype=np.float32)
    m = m.tolil()
    m[7, :] = 0           # an empty row
    m = m.tocsr()
    m.eliminate_zeros()
    x = np.random.default_rng(2).standard_normal(300).astype(np.float32)
    want = jsm.spmv(jsm.CSR.from_scipy(m), jnp.asarray(x))
    A = tsm.CSR.from_scipy(m)
    y = tsm.spmv(A, torch.from_numpy(x))
    assert rel_err(y, want) < 1e-5
    assert torch.equal(y, tsm.spmv(A, torch.from_numpy(x)))


def test_coo_with_duplicates_matches_reference():
    import jax.numpy as jnp

    jsm, _ = ref()
    rng = np.random.default_rng(9)
    r = rng.integers(0, 50, 300)
    c = rng.integers(0, 40, 300)
    v = rng.standard_normal(300).astype(np.float32)
    x = rng.standard_normal(40).astype(np.float32)
    want = jsm.spmv(jsm.COO.from_arrays(jnp.asarray(r, jnp.int32),
                                        jnp.asarray(c, jnp.int32),
                                        jnp.asarray(v), (50, 40)), jnp.asarray(x))
    got = tsm.spmv(tsm.COO.from_arrays(r.astype(np.int32), c.astype(np.int32),
                                       v, (50, 40)), torch.from_numpy(x))
    assert rel_err(got, want) < 1e-5


def test_chain_on_csr_loops_spmv():
    import jax.numpy as jnp

    jsm, _ = ref()
    m = banded(200, (-2, 0, 2), seed=3, scale=0.3)
    x = np.random.default_rng(2).standard_normal(200).astype(np.float32)
    want = jsm.spmv_chain(jsm.CSR.from_scipy(m), jnp.asarray(x), 3)
    got = tsm.spmv_chain(tsm.CSR.from_scipy(m), torch.from_numpy(x), 3)
    assert rel_err(got, want) < 1e-5


# -- wrapper contract on the CPU ------------------------------------------------

def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    td = tsm.CSR.from_scipy(banded(100, (-1, 0, 1))).to_dia()
    x = torch.randn(100)
    kd.reset_launches()
    assert torch.equal(kd.dia_spmv(td, x), kd.dia_spmv_ref(td, x))
    y, d = kd.dia_spmv_dot(td, x)
    y_ref, d_ref = kd.dia_spmv_dot_ref(td, x)
    assert torch.equal(y, y_ref) and torch.equal(d, d_ref)
    assert torch.equal(kd.dia_spmv_chain(td, x, 4), kd.dia_spmv_chain_ref(td, x, 4))
    assert LAUNCHES_ZERO == kd.LAUNCHES


LAUNCHES_ZERO = {"dia_spmv": 0, "dia_spmv_dot": 0, "dia_spmv_chain": 0}


@pytest.mark.parametrize("fn", ["dia_spmv_dot", "dia_spmv_chain"])
def test_wrappers_reject_non_square(fn):
    td = tsm.CSR.from_scipy(banded(50, (0, 1), n_cols=60)).to_dia()
    args = (2,) if fn == "dia_spmv_chain" else ()
    with pytest.raises(ValueError, match="square"):
        getattr(kd, fn)(td, torch.zeros(60), *args)


# -- the CUDA kernels against their plain versions (need a card) -------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CUDA_CASES = [
    (5001, (-64, -1, 0, 1, 64)),              # odd n
    (2048, (-129, -127, 0, 127, 129)),       # offsets straddling 128
    (1, (0,)),                               # a one-row band
    (20000, (-4096, -1, 0, 1, 4096)),        # wide halo
]
TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-12)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offs", CUDA_CASES)
def test_cuda_kernels_match_plain(cuda, dtype, n, offs):
    tol_y, tol_dot = TOL[dtype]
    td = tsm.CSR.from_scipy(banded(n, offs, scale=0.3), device=cuda).to_dia()
    td = tsm.DIA(data=td.data.to(dtype), offsets=td.offsets, shape=td.shape)
    x = torch.randn(n, dtype=dtype, device=cuda)
    kd.reset_launches()
    assert rel_err(kd.dia_spmv(td, x).cpu(), kd.dia_spmv_ref(td, x).cpu()) < tol_y
    (y, d), (y_ref, d_ref) = kd.dia_spmv_dot(td, x), kd.dia_spmv_dot_ref(td, x)
    assert rel_err(y.cpu(), y_ref.cpu()) < tol_y
    assert rel_err(d.item(), d_ref.item()) < tol_dot
    for k in (1, 2, 5):
        got = kd.dia_spmv_chain(td, x, k)
        assert rel_err(got.cpu(), kd.dia_spmv_chain_ref(td, x, k).cpu()) < tol_y
    torch.cuda.synchronize()
    assert kd.LAUNCHES == {"dia_spmv": 1, "dia_spmv_dot": 1, "dia_spmv_chain": 3}


@pytest.mark.cuda
def test_cuda_rectangular_spmv_matches_plain(cuda):
    td = tsm.CSR.from_scipy(banded(3000, (-5, 0, 3, 900), n_cols=4001),
                            device=cuda).to_dia()
    x = torch.randn(4001, device=cuda)
    assert rel_err(kd.dia_spmv(td, x).cpu(), kd.dia_spmv_ref(td, x).cpu()) < 1e-5


@pytest.mark.cuda
def test_cuda_kernels_rerun_bitwise(cuda):
    td = tsm.CSR.from_scipy(banded(100_003, (-300, -1, 0, 1, 300)),
                            device=cuda).to_dia()
    x = torch.randn(100_003, device=cuda)
    y1, d1 = kd.dia_spmv_dot(td, x)
    y2, d2 = kd.dia_spmv_dot(td, x)
    assert torch.equal(y1, y2) and torch.equal(d1, d2)
    assert torch.equal(kd.dia_spmv_chain(td, x, 7), kd.dia_spmv_chain(td, x, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("dt_mat,dt_x", [(torch.bfloat16, torch.bfloat16),
                                         (torch.float16, torch.float16),
                                         (torch.float32, torch.float64),
                                         (torch.bfloat16, torch.float32)])
def test_cuda_low_precision_and_mixed_kernels_match_plain(cuda, dt_mat, dt_x):
    """bf16/f16 storage (accumulated in f32) and mixed operands (promoted)
    run through the kernels and match the plain versions."""
    td = tsm.CSR.from_scipy(banded(20000, (-4096, -1, 0, 1, 4096), scale=0.3),
                            device=cuda).to_dia().astype(dt_mat)
    x = torch.randn(20000, device=cuda).to(dt_x)
    tol = 1e-12 if torch.float64 in (dt_mat, dt_x) else 1e-5
    kd.reset_launches()
    y, y_ref = kd.dia_spmv(td, x), kd.dia_spmv_ref(td, x)
    assert y.dtype == y_ref.dtype
    assert rel_err(y.cpu(), y_ref.cpu()) < tol
    (y, d), (y_ref, d_ref) = kd.dia_spmv_dot(td, x), kd.dia_spmv_dot_ref(td, x)
    assert rel_err(y.cpu(), y_ref.cpu()) < tol
    assert rel_err(d.item(), d_ref.item()) < max(tol, 1e-4)
    for k in (1, 3):
        got, want = kd.dia_spmv_chain(td, x, k), kd.dia_spmv_chain_ref(td, x, k)
        assert got.dtype == want.dtype
        assert rel_err(got.cpu(), want.cpu()) < tol
    torch.cuda.synchronize()
    assert kd.LAUNCHES == {"dia_spmv": 1, "dia_spmv_dot": 1, "dia_spmv_chain": 2}


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    td = tsm.CSR.from_scipy(banded(64, (-1, 0, 1)), device=cuda).to_dia()
    with pytest.raises(TypeError):
        kd.dia_spmv(td, torch.zeros(64, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        kd.dia_spmv(td, torch.zeros(64))                 # vector on the CPU
    with pytest.raises(ValueError):
        kd.dia_spmv(td, torch.zeros(128, device=cuda)[::2])  # not contiguous
