"""The DIA SpMV kernel's plan and (on a CUDA card) the kernel itself.

The plan (``kernels/dia.py`` ``spmv_plan``) is a pure function of the
shape, the offsets, the item size and the card's SMs and occupancy, so the
CPU tests check it against brute force: the tiles cover the rows once,
every x element an interior tile's 16-byte vectors read lies inside the
matrix (so every row that reads outside lies in an edge tile), V is the
16-byte vector exactly where each diagonal's slice is aligned, and the
grid is at most the tile count.

On the card the kernel is held to the plain version (``formats/dia.py``
``dia_spmv``, ``kernels/dia.py`` ``dia_spmv_dot_ref``) with the tolerances
of ``test_torch_dia_kernels.py``: relative to max|reference|, 1e-5 on y in
f32, bf16 and f16 (both widen the same values to f32; fused multiply-adds
against separate roundings), 1e-4 on the dot (another summation order),
1e-12 in f64.  The dot reruns bitwise, one call is one launch, the dot's
counter is back at 0 after calls on two streams, and a CUDA graph's
replays equal the eager call bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch.kernels import dia as kd

#: an H100's SMs
SMS = 132


def per_sm(n):
    """An occupancy of n CTAs an SM for every instantiation."""
    return lambda vec, n_d: n


def rel_err(a, b):
    a = np.asarray(torch.as_tensor(a).double().cpu())
    b = np.asarray(torch.as_tensor(b).double().cpu())
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30) if a.size else 0.0


def offsets_of(seed, n_d, lo, hi):
    """n_d distinct offsets drawn from [lo, hi], ascending."""
    rng = np.random.default_rng(seed)
    pool = np.arange(lo, hi + 1)
    return tuple(sorted(int(o) for o in rng.choice(pool, size=min(n_d, pool.size),
                                                   replace=False)))


# -- the plan against brute force -------------------------------------------

PLAN_CASES = [
    # (n_rows, n_cols, offsets)
    (2048 * 2048, 2048 * 2048, (-2048, -1, 0, 1, 2048)),   # the CG operand
    (1 << 24, 1 << 24, (-4096, -1, 0, 1, 4096)),           # the 2^24 band
    (4096, 4096, (-64, -1, 0, 1, 64)),
    (16384, 16384, (-128, -1, 0, 1, 128)),
    (1000, 1000, (-1, 0, 1)),
    (1001, 1001, (-1, 0, 1)),                             # n not a multiple of any V
    (1, 1, (0,)),
    (0, 0, ()),
    (5000, 5000, ()),
    (300, 300, (-7, 0, 13)),
    (2048, 2048, (-129, -127, 0, 127, 129)),
    (3000, 4001, (-5, 0, 3, 900)),                        # wide
    (4001, 3000, (-5, 0, 3, 900)),                        # tall
    (700, 900, (-5, 0, 3, 40)),
    (1024, 1024, (-5000, 0, 5000)),                       # offsets past n
    (1024, 1024, (2000,)),
    (4096, 4096, (1, 2, 3, 7, 100)),                      # all positive
    (4096, 4096, (-300, -9, -2, -1)),                     # all negative
    (8192, 8192, offsets_of(1, 9, -40, 40)),
    (8192, 8192, offsets_of(2, 27, -500, 500)),
    (8192, 8200, offsets_of(3, 33, -3000, 3000)),
    (12345, 12345, offsets_of(4, 17, -2000, 2000)),
    (65536, 65536, offsets_of(5, 2, -65535, 65535)),
    (256, 256, (-255, 255)),
    (2048, 2048, (-2047, 0, 2047)),
]


def brute_interior_ok(plan, n_rows, n_cols, offsets, t):
    """Whether tile t reads only inside the matrix, from every thread's
    loads: its rows, and for each diagonal the aligned x vector at q and,
    where the offset is near, the one at q + 1."""
    v, base = plan.vec, t * plan.tile
    i0 = base + np.arange(0, plan.tile, v)
    if base + plan.tile > n_rows:
        return False
    for o in offsets:
        q = o // v
        starts = [i0 + q * v] + ([i0 + (q + 1) * v] if o % v else [])
        for s in starts:
            if s.min() < 0 or s.max() + v > n_cols:
                return False
    return True


@pytest.mark.parametrize("itemsize", [2, 4, 8])
@pytest.mark.parametrize("n_rows,n_cols,offsets", PLAN_CASES)
def test_plan_against_brute_force(n_rows, n_cols, offsets, itemsize):
    plan = kd.spmv_plan(n_rows, n_cols, offsets, itemsize, SMS, per_sm(3))
    v = 16 // itemsize
    # V is the 16-byte vector where each diagonal's slice is aligned
    assert plan.vec == (v if (n_rows * itemsize) % 16 == 0 else 1)
    assert plan.tile == kd.SPMV_THREADS * plan.vec
    # the tiles cover [0, n_rows) once, and the grid's walk takes each once
    assert plan.tiles == max(1, -(-n_rows // plan.tile))
    assert (plan.tiles - 1) * plan.tile < max(n_rows, 1) <= plan.tiles * plan.tile
    walked = sorted(t for b in range(plan.grid) for t in range(b, plan.tiles, plan.grid))
    assert walked == list(range(plan.tiles))
    assert 1 <= plan.grid <= plan.tiles and plan.grid == min(SMS * 3, plan.tiles)
    # interior tiles read inside the matrix; rows that read outside are edge
    lo, hi = plan.interior
    assert 0 <= lo <= hi <= plan.tiles
    edge = set(plan.edge_tiles)
    assert edge == set(range(plan.tiles)) - set(range(lo, hi))
    check = sorted(set(range(min(plan.tiles, 40))) | set(range(max(0, plan.tiles - 40),
                                                               plan.tiles))
                   | {lo, hi - 1, lo - 1, hi} & set(range(plan.tiles)))
    for t in check:
        if lo <= t < hi:
            assert brute_interior_ok(plan, n_rows, n_cols, offsets, t), t
    rows = np.arange(n_rows)
    outside = np.zeros(n_rows, bool)
    for o in offsets:
        outside |= (rows + o < 0) | (rows + o >= n_cols)
    assert set((rows[outside] // plan.tile).tolist()) <= edge
    # every tile past the rows is an edge tile
    assert all(t in edge for t in range(plan.tiles) if (t + 1) * plan.tile > n_rows)
    # the compiled count, and the near/far split by the vector
    spec = len(offsets) in kd.SPECIALISED and plan.vec > 1
    assert plan.n_d == (len(offsets) if spec else 0)
    assert plan.near == tuple(d for d, o in enumerate(offsets) if o % plan.vec)
    assert sorted(plan.near + plan.far) == list(range(len(offsets)))
    assert list(plan.offsets_host)[:len(offsets)] == list(offsets)


@pytest.mark.parametrize("aligned", [True, False])
def test_plan_takes_vec_1_for_unaligned_pointers(aligned):
    plan = kd.spmv_plan(4096, 4096, (-64, -1, 0, 1, 64), 4, SMS, per_sm(4),
                        aligned=aligned)
    assert plan.vec == (4 if aligned else 1)
    assert plan.n_d == (5 if aligned else 0)
    assert plan.near == ((1, 3) if aligned else ())


def test_plan_of_the_timed_operands():
    """The plans chip_smoke.py times: the 2048² Poisson band in f32, f64
    and bf16, and the 2^24-row band, at 4 CTAs an SM."""
    n = 2048 * 2048
    p32 = kd.spmv_plan(n, n, (-2048, -1, 0, 1, 2048), 4, SMS, per_sm(4))
    assert (p32.vec, p32.tile, p32.tiles, p32.n_d, p32.grid) == (4, 1024, 4096, 5, 528)
    assert p32.edge_tiles == [0, 1, 4094, 4095]
    assert p32.near == (1, 3) and p32.far == (0, 2, 4)
    p64 = kd.spmv_plan(n, n, (-2048, -1, 0, 1, 2048), 8, SMS, per_sm(4))
    assert (p64.vec, p64.tile, p64.tiles) == (2, 512, 8192)
    assert p64.edge_tiles == [0, 1, 2, 3, 8188, 8189, 8190, 8191]
    p16 = kd.spmv_plan(n, n, (-2048, -1, 0, 1, 2048), 2, SMS, per_sm(4))
    assert (p16.vec, p16.tile, p16.edge_tiles) == (8, 2048, [0, 2047])
    nb = 1 << 24
    pb = kd.spmv_plan(nb, nb, (-4096, -1, 0, 1, 4096), 4, SMS, per_sm(4))
    assert pb.edge_tiles == [0, 1, 2, 3, 16380, 16381, 16382, 16383]


def test_plan_reads_the_instantiations_occupancy():
    seen = []

    def per_sm(vec, n_d):
        seen.append((vec, n_d))
        return 2

    plan = kd.spmv_plan(1000, 1000, (-1, 0, 1, 5, 9, 11, 13, 20, 40), 4, 10, per_sm)
    assert seen == [(4, 0)] and plan.grid == 1 and plan.n_d == 0


def test_promoted_data_is_made_once():
    m = sp.diags([np.ones(50), np.ones(49)], [0, 1], format="csr").astype(np.float32)
    td = tsm.CSR.from_scipy(m).to_dia()
    assert kd.promoted_data(td, torch.float32) is td.data
    p = kd.promoted_data(td, torch.float64)
    assert p.dtype == torch.float64 and torch.equal(p, td.data.double())
    assert kd.promoted_data(td, torch.float64) is p


# -- the kernel on the card ---------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TOL = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-12),
       torch.bfloat16: (1e-5, 1e-4), torch.float16: (1e-5, 1e-4)}


def band(n_rows, n_cols, offsets, dtype, device, seed=0):
    """A DIA of random values in [-0.5, 0.5) on the band (zero outside the
    matrix), and x, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    data = rng.random((len(offsets), n_rows)) - 0.5
    i = np.arange(n_rows)
    for d, o in enumerate(offsets):
        data[d][(i + o < 0) | (i + o >= n_cols)] = 0
    x = rng.standard_normal(n_cols)
    A = tsm.DIA(data=torch.tensor(data, device=device).to(dtype).contiguous(),
                offsets=tuple(offsets), shape=(n_rows, n_cols))
    return A, torch.tensor(x, device=device).to(dtype)


def sizes(dtype):
    """n < T, n = T and n = T + 1, and n a multiple of 2 but of no larger
    vector, for a tile of T rows in ``dtype``."""
    t = kd.SPMV_THREADS * 16 // dtype.itemsize
    return [t // 2, t, t + 1, 3 * t + 2]


def held(A, x, dtype, square=True):
    tol_y, tol_dot = TOL[dtype]
    y, y_ref = kd.dia_spmv(A, x), kd.dia_spmv_ref(A, x)
    assert y.dtype == y_ref.dtype
    assert rel_err(y, y_ref) < tol_y
    if square:
        (y, d), (y_ref, d_ref) = kd.dia_spmv_dot(A, x), kd.dia_spmv_dot_ref(A, x)
        assert d.dim() == 0 and d.dtype == d_ref.dtype
        assert rel_err(y, y_ref) < tol_y
        assert rel_err(d, d_ref) < tol_dot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-64, -1, 0, 1, 64), (-3, 0, 5, 8)])
def test_cuda_kernel_at_tile_edges(cuda, dtype, offsets):
    for n in sizes(dtype):
        A, x = band(n, n, offsets, dtype, cuda, seed=n)
        plan = kd.dia_spmv_plan(A, dtype, cuda)
        assert plan.vec == (16 // dtype.itemsize if n % (16 // dtype.itemsize) == 0 else 1)
        held(A, x, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(3000, 4096), (4096, 3000)])
def test_cuda_kernel_rectangular(cuda, dtype, shape):
    A, x = band(*shape, (-700, -5, 0, 3, 1200), dtype, cuda, seed=7)
    held(A, x, dtype, square=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n_d", [1, 9, 33])
def test_cuda_kernel_runtime_count(cuda, dtype, n_d):
    offsets = (0,) if n_d == 1 else offsets_of(n_d, n_d, -300, 300)
    A, x = band(20_000, 20_000, offsets, dtype, cuda, seed=n_d)
    assert kd.dia_spmv_plan(A, dtype, cuda).n_d == 0
    held(A, x, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("side", [32, 96])
def test_cuda_kernel_on_poisson_offsets(cuda, dtype, side):
    """The 2048² operator's offsets (-s, -1, 0, 1, s) at a small side, and
    the 27-point stencil's offsets (the runtime-count loop)."""
    A, x = band(side * side, side * side, (-side, -1, 0, 1, side), dtype, cuda, seed=side)
    assert kd.dia_spmv_plan(A, dtype, cuda).n_d == 5
    held(A, x, dtype)
    s = side // 4
    offs = sorted({a * s * s + b * s + c for a in (-1, 0, 1) for b in (-1, 0, 1)
                   for c in (-1, 0, 1)})
    A, x = band(s ** 3 * 4, s ** 3 * 4, offs, dtype, cuda, seed=s)
    assert kd.dia_spmv_plan(A, dtype, cuda).n_d == 0
    held(A, x, dtype)


@pytest.mark.cuda
def test_cuda_kernel_on_unaligned_x_takes_vec_1(cuda):
    A, x = band(4096, 4096, (-64, -1, 0, 1, 64), torch.float32, cuda)
    buf = torch.empty(4097, device=cuda)
    buf[1:] = x
    xu = buf[1:]
    assert xu.data_ptr() % 16 != 0
    y, d = kd.dia_spmv_dot(A, xu)
    y_ref, d_ref = kd.dia_spmv_dot_ref(A, x)
    assert rel_err(y, y_ref) < 1e-5 and rel_err(d, d_ref) < 1e-4
    assert kd.dia_spmv_plan(A, torch.float32, cuda, aligned=False).vec == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_dot_reruns_bitwise_in_one_launch(cuda, dtype):
    from torch.profiler import ProfilerActivity, profile

    A, x = band(300_000, 300_000, (-512, -1, 0, 1, 512), dtype, cuda)
    y0, d0 = kd.dia_spmv_dot(A, x)
    for _ in range(5):
        y, d = kd.dia_spmv_dot(A, x)
        assert torch.equal(y, y0) and torch.equal(d, d0)
    torch.cuda.synchronize()
    kd.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kd.dia_spmv_dot(A, x)
        torch.cuda.synchronize()
    assert kd.LAUNCHES["dia_spmv_dot"] == 1
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA for _ in range(e.count)]
    assert len(kernels) == 1 and "dia_spmv_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_cuda_dot_counters_on_two_streams(cuda):
    A, x = band(200_000, 200_000, (-256, -1, 0, 1, 256), torch.float32, cuda)
    y0, d0 = kd.dia_spmv_dot(A, x)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    out = []
    for i in range(8):
        s = streams[i % 2]
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            out.append(kd.dia_spmv_dot(A, x))
    torch.cuda.synchronize()
    for y, d in out:
        assert torch.equal(y, y0) and torch.equal(d, d0)
    for s in streams:
        _, counter = kd._dot_scratch[(x.device, s.cuda_stream)]
        assert int(counter.item()) == 0


@pytest.mark.cuda
def test_cuda_dot_in_a_cuda_graph(cuda, monkeypatch):
    """Two graphs captured on one stream, each launch with a counter of its
    own: replayed second first, interleaved with eager calls on the
    capture's stream, and at once on two streams, each equals the eager
    call bitwise and leaves every counter at 0."""
    A, x = band(100_000, 100_000, (-316, -1, 0, 1, 316), torch.float32, cuda)
    y0, d0 = kd.dia_spmv_dot(A, x)
    made = []
    real = kd.dot_scratch

    def recording(device, stream):
        made.append(real(device, stream))
        return made[-1]

    monkeypatch.setattr(kd, "dot_scratch", recording)
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(cap):
        kd.dia_spmv_dot(A, x)             # warm up on the capture stream
    torch.cuda.current_stream().wait_stream(cap)
    graphs, outs = [], []
    for _ in range(2):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=cap):
            outs.append(kd.dia_spmv_dot(A, x))
        graphs.append(g)
    eager, captured = made[0][1], [m[1] for m in made[1:]]
    assert len(captured) == 2
    ptrs = {c.data_ptr() for c in [eager] + captured}
    assert len(ptrs) == 3

    def held(i):
        torch.cuda.synchronize()
        y, d = outs[i]
        assert torch.equal(y, y0) and torch.equal(d, d0)
        for c in [eager] + captured:
            assert int(c.item()) == 0

    for i in (1, 0, 1):
        outs[i][0].zero_()
        outs[i][1].zero_()
        graphs[i].replay()
        held(i)
        with torch.cuda.stream(cap):
            y, d = kd.dia_spmv_dot(A, x)
        torch.cuda.synchronize()
        assert torch.equal(y, y0) and torch.equal(d, d0)
    sides = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(3):
        for i, s in enumerate(sides):
            outs[i][0].zero_()
            outs[i][1].zero_()
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                graphs[i].replay()
        held(0)
        held(1)
