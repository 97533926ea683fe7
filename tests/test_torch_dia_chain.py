"""The DIA chain's two kernels: the plan that picks between them, the
cluster kernel's schedule walked in plain torch on the CPU, and (on a
CUDA card) both kernels against the plain chain.

The plan is a pure function of the band's size and the card's limits, so
its tests give the limits.  The walk (``dia_chain_cluster_walk``) replays
the cluster kernel's slices, owner ranks, local slots and ping-pong
buffers; it is held bitwise to the plain chain (the same sums in the same
order) and within 1e-5 of max|reference| (f32) to the JAX package's
resident chain run in interpret mode.  On the card the kernels are held to
the plain chain with ``test_torch_dia_kernels.py``'s tolerances (1e-5 in
f32, fused multiply-adds against separate roundings; 1e-12 in f64).  The
JAX package is imported inside the tests, so the ``cuda`` tests also run on
a machine without JAX (``-m cuda --noconftest``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch.kernels import dia as kd

#: an H100's opt-in shared memory per CTA (227 KB) and its largest cluster
SMEM = 232_448
MOST = 16
BAND = (-100, -1, 0, 1, 100)


def banded(n, offs, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    m = sp.diags([rng.standard_normal(2 * n) * scale for _ in offs], offs,
                 shape=(n, n), format="csr")
    return m.astype(np.float32)


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def averaging(n, offs, seed=0):
    """An n-row band with nonnegative weights, each row summing to 1, so
    Aᵏx stays bounded at any k."""
    w = np.random.default_rng(seed).random((len(offs), n))
    i = np.arange(n)
    for d, o in enumerate(offs):
        w[d][(i + o < 0) | (i + o >= n)] = 0
    w /= w.sum(0)
    diags = [w[d][max(0, -o):n - max(0, o)] for d, o in enumerate(offs)]
    return sp.diags(diags, offs, shape=(n, n), format="csr").astype(np.float32)


def largest_n(n_d, itemsize, halo, smem=SMEM, most=MOST):
    """The most rows a cluster of ``most`` CTAs holds, from the layout:
    n_d diagonal slices of ``rows`` values, two x buffers of rows + halo
    values, n_d int32 shifts."""
    rows = (smem - 4 * n_d - 2 * halo * itemsize) // ((n_d + 2) * itemsize)
    return most * rows


# -- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_picks_the_cluster_for_the_benchmark_band(itemsize):
    c = kd.cluster_size(10_000, 5, itemsize, 200, SMEM, MOST)
    assert c == kd.DEFAULT_CLUSTER
    assert kd.cluster_smem(10_000, 5, itemsize, c, 200) <= SMEM


@pytest.mark.parametrize("n,n_d,halo", [(2048 * 2048, 5, 4096),
                                        (largest_n(5, 4, 200) + 16, 5, 200),
                                        (400_000, 1, 0), (10_000, 200, 200),
                                        (20_000, 5, 40_000)])
def test_plan_picks_the_grid_past_one_cluster(n, n_d, halo):
    assert kd.cluster_size(n, n_d, 4, halo, SMEM, MOST) is None


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_plan_for_fewer_rows_than_ctas(n):
    c = kd.cluster_size(n, 3, 4, 2 * n, SMEM, MOST)
    assert 1 <= c <= MOST
    assert kd.cluster_rows(n, c) == 1


@pytest.mark.parametrize("most", [16, 8, 2, 1])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("halo", [0, 200, 8192])
def test_plan_boundary_is_the_layout_capacity(halo, itemsize, most):
    n_max = largest_n(5, itemsize, halo, most=most)
    assert kd.cluster_size(n_max, 5, itemsize, halo, SMEM, most) == most
    assert kd.cluster_size(n_max + 1, 5, itemsize, halo, SMEM, most) is None


def test_f64_halves_the_capacity():
    n32, n64 = largest_n(5, 4, 0), largest_n(5, 8, 0)
    assert abs(n32 - 2 * n64) <= MOST
    assert kd.cluster_size(n64 + 1, 5, 8, 0, SMEM, MOST) is None
    assert kd.cluster_size(n64 + 1, 5, 4, 0, SMEM, MOST) is not None


def test_plan_takes_more_ctas_only_where_the_band_needs_them():
    # 10^5 f32 rows need 16 CTAs; a card that places at most 4 gets none
    assert kd.cluster_size(100_000, 5, 4, 200, SMEM, 16, default=2) == 16
    assert kd.cluster_size(100_000, 5, 4, 200, SMEM, 4) is None
    # 40,000 rows need 8 CTAs
    assert kd.cluster_size(40_000, 5, 4, 200, SMEM, 16, default=2) == 8
    # a default above the card's largest cluster falls to the largest
    assert kd.cluster_size(1000, 5, 4, 200, SMEM, 4, default=16) == 4
    assert kd.cluster_size(1000, 5, 4, 200, SMEM, 16, default=2) == 2


def test_halos():
    assert kd.chain_halos(BAND, 10_000) == (100, 100)
    assert kd.chain_halos((0, 3), 10) == (0, 3)
    assert kd.chain_halos((-50, 2), 10) == (10, 2)
    assert kd.chain_halos((), 10) == (0, 0)


# -- the schedule's walk --------------------------------------------------------

WALK_CASES = [
    (5001, (-64, -1, 0, 1, 64)),          # offsets within one slice, odd n
    (20000, (-4096, -1, 0, 1, 4096)),     # halos spanning several slices
    (10_000, BAND),                       # the benchmark's band
    (7, (-2, 0, 3)),                      # fewer rows than CTAs
    (1, (0,)),                            # one row
]


@pytest.mark.parametrize("cluster", kd.CLUSTER_SIZES)
@pytest.mark.parametrize("n,offs", WALK_CASES)
def test_walk_is_bitwise_the_plain_chain(n, offs, cluster):
    td = tsm.CSR.from_scipy(banded(n, offs)).to_dia()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n).astype(np.float32))
    for k in (1, 2, 5):
        assert torch.equal(kd.dia_chain_cluster_walk(td, x, k, cluster),
                           kd.dia_spmv_chain_ref(td, x, k))


@pytest.mark.parametrize("cluster", [4, 16])
def test_walk_in_f64(cluster):
    td = tsm.CSR.from_scipy(banded(3001, BAND).astype(np.float64)).to_dia()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(3001))
    got = kd.dia_chain_cluster_walk(td, x, 5, cluster)
    assert got.dtype == torch.float64
    assert torch.equal(got, kd.dia_spmv_chain_ref(td, x, 5))


@pytest.mark.parametrize("rows", [1, 3, 7, 625])
def test_push_targets_are_the_ctas_whose_halo_holds_the_row(rows):
    """The kernel's push targets (mirrored by ``push_targets``) against
    their definition: every other CTA t that owns rows and whose buffers
    cover row i, t·rows − lo ≤ i < (t+1)·rows + hi."""
    for lo in (0, 1, 2, 5, rows, rows + 1, 3 * rows):
        for hi in (0, 1, 3, rows, rows + 2, 2 * rows + 1):
            for n in (1, 4 * rows - 1, 4 * rows):
                n_live = (n - 1) // rows + 1
                for i in range(n):
                    want = [t for t in range(n_live) if t != i // rows
                            and t * rows - lo <= i < (t + 1) * rows + hi]
                    assert kd.push_targets(i, rows, lo, hi, n_live) == want


def test_walk_checks_every_halo_is_filled(monkeypatch):
    """A push target missed leaves a stale halo slot, which the walk finds
    before the next step reads it."""
    td = tsm.CSR.from_scipy(banded(1000, (-30, 0, 30))).to_dia()
    x = torch.ones(1000)
    targets = kd.push_targets
    monkeypatch.setattr(kd, "push_targets", lambda *a: targets(*a)[1:])
    with pytest.raises(AssertionError, match="misses"):
        kd.dia_chain_cluster_walk(td, x, 2, 4)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("n,offs,cluster", [(300, (-3, -1, 0, 1, 3), 4),
                                            (2001, (-700, -1, 0, 1, 700), 8),
                                            (5001, (-64, -1, 0, 1, 64), 16),
                                            (20000, (-4096, -1, 0, 1, 4096), 8)])
def test_walk_matches_pallas(n, offs, cluster, k):
    """Against the JAX package's resident chain, run as its own tests run
    it: ``dia_spmv_chain_pallas(..., interpret=True)``."""
    import jax.numpy as jnp

    jsm = pytest.importorskip("sparsemat_tpu")
    from sparsemat_tpu.kernels import dia as jkd

    m = banded(n, offs, scale=0.05)
    jd = jsm.CSR.from_scipy(m).to_dia()
    assert jkd.dia_chain_plan(jd) is not None
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    want = jkd.dia_spmv_chain_pallas(jd, jnp.asarray(x), k, interpret=True)
    td = tsm.CSR.from_scipy(m).to_dia()
    got = kd.dia_chain_cluster_walk(td, torch.from_numpy(x), k, cluster)
    assert rel_err(got, want) < 1e-5


# -- the wrapper on the CPU ------------------------------------------------------

def test_cpu_chain_takes_the_plain_version_and_counts_nothing():
    td = tsm.CSR.from_scipy(banded(500, BAND)).to_dia()
    x = torch.randn(500)
    kd.reset_launches()
    assert torch.equal(kd.dia_spmv_chain(td, x, 3), kd.dia_spmv_chain_ref(td, x, 3))
    assert kd.CHAIN_KERNELS == {"cluster": 0, "grid": 0}
    assert kd.LAUNCHES["dia_spmv_chain"] == 0


# -- the kernels on the card -----------------------------------------------------

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
    (10_000, BAND),                          # the benchmark's band
]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def card_dia(n, offs, dtype, device, make=banded):
    td = tsm.CSR.from_scipy(make(n, offs), device=device).to_dia()
    return tsm.DIA(data=td.data.to(dtype), offsets=td.offsets, shape=td.shape)


def accepted_plans(td, dtype):
    """The cluster kernel at every size the card accepts where the band
    fits, at the plan's CTA size and at 1,024 threads (several passes a
    step where the slice is long)."""
    n, n_d = td.shape[0], len(td.offsets)
    halo = sum(kd.chain_halos(td.offsets, n))
    smem, most = kd.cluster_limits(td.data.device, dtype)
    return [kd.cluster_plan(td, dtype, c, t) for t in (None, 1024) for c in kd.CLUSTER_SIZES
            if c <= most and kd.cluster_smem(n, n_d, dtype.itemsize, c, halo) <= smem]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offs", CUDA_CASES)
def test_cuda_cluster_kernel_matches_plain(cuda, dtype, n, offs):
    # k = 1024 on the benchmark's band needs weights whose powers stay bounded
    td = card_dia(n, offs, dtype, cuda, averaging if n == 10_000 else banded)
    x = torch.randn(n, dtype=dtype, device=cuda)
    plans = accepted_plans(td, dtype)
    assert plans, "the band fits no cluster the card accepts"
    ks = (1, 2, 5, 1024) if n == 10_000 else (1, 2, 5)
    kd.reset_launches()
    for k in ks:
        want = kd.dia_spmv_chain_ref(td, x, k).cpu()
        for plan in plans:
            got = kd.dia_spmv_chain(td, x, k, plan)
            assert rel_err(got.cpu(), want) < TOL[dtype], (k, plan)
    torch.cuda.synchronize()
    assert kd.CHAIN_KERNELS == {"cluster": len(ks) * len(plans), "grid": 0}
    assert kd.LAUNCHES["dia_spmv_chain"] == len(ks) * len(plans)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_cluster_kernel_reruns_bitwise(cuda, dtype):
    td = card_dia(10_000, BAND, dtype, cuda, averaging)
    x = torch.randn(10_000, dtype=dtype, device=cuda)
    for plan in accepted_plans(td, dtype):
        assert torch.equal(kd.dia_spmv_chain(td, x, 1024, plan),
                           kd.dia_spmv_chain(td, x, 1024, plan))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_plan_boundary(cuda, dtype):
    """The last n on the cluster kernel, the first on the grid; both right."""
    smem, most = kd.cluster_limits(cuda, dtype)
    n_max = largest_n(5, dtype.itemsize, 600, smem, most)
    x = torch.randn(n_max + 1, dtype=dtype, device=cuda)
    for n, kernel in ((n_max, "cluster"), (n_max + 1, "grid")):
        td = card_dia(n, (-300, -1, 0, 1, 300), dtype, cuda)
        assert kd.dia_chain_plan(td, dtype).kernel == kernel
        kd.reset_launches()
        got = kd.dia_spmv_chain(td, x[:n], 2)
        assert rel_err(got.cpu(), kd.dia_spmv_chain_ref(td, x[:n], 2).cpu()) < TOL[dtype]
        assert kd.CHAIN_KERNELS[kernel] == 1 and kd.LAUNCHES["dia_spmv_chain"] == 1


@pytest.mark.cuda
def test_cuda_chain_counts_each_kernel(cuda):
    small = card_dia(10_000, BAND, torch.float32, cuda)
    large = card_dia(300_000, BAND, torch.float32, cuda)
    kd.reset_launches()
    tsm.spmv_chain(small, torch.randn(10_000, device=cuda), 8)
    tsm.spmv_chain(large, torch.randn(300_000, device=cuda), 8)
    torch.cuda.synchronize()
    assert kd.CHAIN_KERNELS == {"cluster": 1, "grid": 1}
    assert kd.LAUNCHES["dia_spmv_chain"] == 2


@pytest.mark.cuda
def test_cuda_oversized_cluster_raises(cuda):
    td = card_dia(10_000, BAND, torch.float32, cuda)
    x = torch.randn(10_000, device=cuda)
    plan = kd.cluster_plan(td, torch.float32, 32)      # more CTAs than a cluster takes
    kd.reset_launches()
    with pytest.raises(RuntimeError, match="cluster kernel"):
        kd.dia_spmv_chain(td, x, 3, plan)
    assert kd.CHAIN_KERNELS == {"cluster": 0, "grid": 0}
    with pytest.raises(ValueError, match="shared bytes"):
        kd.cluster_plan(card_dia(100_000, BAND, torch.float32, cuda), torch.float32, 1)
    # the card is still usable: the same chain on an accepted plan
    got = kd.dia_spmv_chain(td, x, 3)
    assert rel_err(got.cpu(), kd.dia_spmv_chain_ref(td, x, 3).cpu()) < 1e-5
