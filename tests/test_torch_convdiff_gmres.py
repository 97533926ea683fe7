"""Restarted GMRES on the 3-D convection–diffusion operator of the
benchmark's ``convdiff3d_256`` configuration, on the CPU at 12³–16³ rows:
the frozen generator against the upwind stencil applied matrix-free, its
freeze to DIA, the port's ``solvers.gmres`` against the plain GMRES of
``portbench/reference/gmres.py``, the solver's spans and counters and the
reader of ``kernel.gmres_step_roofline``, and both cells that this
configuration and ``fem_pwtk.spmm8`` add, run through the harness at a
shrunk size, where the controls (the program's and the reference's
bfloat16 paths, and a solve stopped at rtol 1e-4) are judged not correct.

Tolerances.  The port projects by classical Gram–Schmidt and the reference
by modified Gram–Schmidt, with products and dots summed in other orders.
In f64 the two Arnoldi processes agree to ~10⁻¹³ at this size, so both take
the same cycles and their x agree within 10⁻¹⁰.  In f32 the stopping tests
sit on rounded residuals, so a solve may take one cycle more on one side:
the cycle counts are held within one, and each true residual, in f64,
under rtol.  The generator's entries are held to the stencil within 10⁻¹²
of the largest product, which is ~4·10⁴ times u at 12³.
"""

import os
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import solvers
from sparsemat_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "portbench")
CELL = "convdiff3d_256.gmres"
GAMMA = 1000.0
RTOL = 1e-5
RESTART = 30


@pytest.fixture(autouse=True)
def bench_path(monkeypatch):
    """The harness's modules importable, and PyTorch's CPU ops on one
    thread (the solves are thousands of small ops)."""
    monkeypatch.syspath_prepend(BENCH)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def generator():
    import harness

    return harness.load_module(os.path.join(BENCH, "configs", "convdiff7.py"))


def reference_gmres():
    from reference.gmres import gmres

    return gmres


def operator(n, dtype):
    """(the port's frozen operator, its CSR, the triplets) at n³ rows."""
    rows, cols, vals = generator().convdiff_triplets(n, GAMMA)
    b = tsm.SparseBuilder(rows.size, dtype=dtype)
    b.add_batch(rows, cols, vals.astype(np.float64 if dtype == torch.float64 else np.float32))
    csr = b.to_csr(device="cpu")
    return tsm.auto_format(csr), csr, (rows, cols, vals)


class PlainOperator:
    """A·v from triplets by ``index_add_``, in ``dtype``."""

    def __init__(self, rows, cols, vals, n, dtype):
        self.rows = torch.from_numpy(rows)
        self.cols = torch.from_numpy(cols)
        self.vals = torch.from_numpy(vals).to(dtype)
        self.n, self.dtype = n, dtype

    def matmul(self, v):
        y = torch.zeros(self.n, dtype=self.dtype)
        return y.index_add_(0, self.rows, self.vals * v.to(self.dtype)[self.cols])

    def diagonal(self):
        on = self.rows == self.cols
        return torch.zeros(self.n, dtype=self.dtype).index_add_(0, self.rows[on], self.vals[on])


def stencil(u, gamma):
    """−Δu + β·∇u on the n³ grid function ``u`` (indexed [z, y, x]), zero
    outside: the 7-point Laplacian and first-order upwind differences,
    β = γ·(e^{xy}, e^{−xy}, 1) at each node, in plain torch."""
    n = u.shape[0]
    h = 1.0 / (n + 1)
    c = (torch.arange(n, dtype=u.dtype) + 1) * h
    xy = c[None, None, :] * c[None, :, None]
    beta = (gamma * torch.exp(xy), gamma * torch.exp(-xy), torch.full_like(xy, gamma))
    p = F.pad(u, (1, 1, 1, 1, 1, 1))
    inner = (slice(1, -1),) * 3
    out = 6.0 * u / h ** 2
    for axis, b in zip((2, 1, 0), beta):     # x, y, z: the last, middle, first index
        lo, hi = list(inner), list(inner)
        lo[axis], hi[axis] = slice(0, -2), slice(2, None)
        lower, upper = p[tuple(lo)], p[tuple(hi)]
        out = out - (lower + upper) / h ** 2
        out = out + torch.where(b > 0, b * (u - lower), b * (upper - u)) / h
    return out


def test_generator_is_the_upwind_stencil():
    n = 12
    rows, cols, vals = generator().convdiff_triplets(n, GAMMA)
    assert rows.size == 7 * n ** 3 - 6 * n ** 2
    u = torch.randn((n, n, n), dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    got = PlainOperator(rows, cols, vals, n ** 3, torch.float64).matmul(u.reshape(-1))
    want = stencil(u, GAMMA).reshape(-1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * float(want.abs().max()))


def test_configuration_counts_and_freezes_to_seven_diagonals():
    import harness

    cfg = harness.Cell(CELL).config
    n = int(cfg["grid"])
    assert cfg["rows"] == n ** 3 and cfg["stored_entries"] == 7 * n ** 3 - 6 * n ** 2
    A, _, _ = operator(12, torch.float32)
    assert isinstance(A, tsm.DIA)
    assert sorted(int(o) for o in A.offsets) == [-144, -12, -1, 0, 1, 12, 144]


def _solve_both(dtype, jacobi, seed=2**31 + 7):
    n = 16
    A, csr, (rows, cols, vals) = operator(n, dtype)
    b = torch.randn(n ** 3, generator=torch.Generator().manual_seed(seed)).to(dtype)
    M = solvers.JacobiPreconditioner.from_matrix(csr) if jacobi else None
    x, info = solvers.gmres(A, b, tol=0.0, rtol=RTOL, maxiter=20000, M=M)
    op = PlainOperator(rows, cols, vals, n ** 3, dtype)
    dinv = 1.0 / op.diagonal() if jacobi else None
    xr, k, ok = reference_gmres()(op, b, tol=0.0, rtol=RTOL, maxiter=20000, dinv=dinv)
    assert bool(info.converged) and ok
    op64 = PlainOperator(rows, cols, vals, n ** 3, torch.float64)
    res = [float(torch.linalg.vector_norm(b.double() - op64.matmul(v.double()))
                 / torch.linalg.vector_norm(b.double())) for v in (x, xr)]
    return x, int(info.iterations), xr, k, res


@pytest.mark.parametrize("jacobi", [False, True])
def test_gmres_f64_matches_the_reference(jacobi):
    x, k, xr, kr, res = _solve_both(torch.float64, jacobi)
    assert k == kr and k % RESTART == 0
    assert float(torch.linalg.vector_norm(x - xr) / torch.linalg.vector_norm(xr)) < 1e-10
    assert max(res) < RTOL


@pytest.mark.parametrize("jacobi", [False, True])
def test_gmres_f32_matches_the_reference(jacobi):
    _, k, _, kr, res = _solve_both(torch.float32, jacobi)
    assert abs(k - kr) <= RESTART
    assert max(res) < RTOL


def _diagonal_solve(distinct, maxiter, rtol):
    """GMRES on a diagonal operator of 200 rows with ``distinct`` values
    1, 2, ... repeated, from a dense b: the Krylov space has dimension
    ``distinct``, so an exact solve ends at that step."""
    d = (torch.arange(200, dtype=torch.float64) % distinct) + 1
    b = torch.randn(200, dtype=torch.float64, generator=torch.Generator().manual_seed(11))
    return solvers.gmres(lambda v: d * v, b, tol=0.0, rtol=rtol, maxiter=maxiter)


@pytest.mark.parametrize("distinct, maxiter, rtol, cycles, committed", [
    (5, 20000, 1e-10, 1, 5),      # converges at step 5 of its first cycle
    (200, 60, 1e-30, 2, 60),      # stopped by maxiter: every step of two cycles committed
])
def test_tracing_counts_cycles_steps_and_arnoldi_rows(distinct, maxiter, rtol, cycles,
                                                      committed):
    profiling.reset_trace()
    with profiling.tracing():
        _, info = _diagonal_solve(distinct, maxiter, rtol)
    c = profiling.trace_record()["counters"]["solver"]
    span = profiling.trace_record()["spans"]["solver.block"]
    assert int(info.iterations) == c["steps_executed"] == cycles * RESTART
    assert c["cycles"] == span["count"] == cycles
    assert c["steps_committed"] == committed
    # step j of a cycle projects against basis rows 0..j
    per_cycle = [min(committed - RESTART * i, RESTART) for i in range(cycles)]
    rows = sum(j + 1 for s in per_cycle for j in range(s))
    assert c["arnoldi_rows"] == rows
    assert c["arnoldi_bytes"] == rows * 200 * 8
    profiling.reset_trace()


def test_tracing_off_counts_nothing_and_tracing_changes_no_answer():
    A, csr, _ = operator(12, torch.float32)
    M = solvers.JacobiPreconditioner.from_matrix(csr)
    b = torch.randn(12 ** 3, generator=torch.Generator().manual_seed(5))
    profiling.reset_trace()
    x0, i0 = solvers.gmres(A, b, tol=0.0, rtol=RTOL, maxiter=20000, M=M)
    assert profiling.trace_record()["counters"]["solver"]["cycles"] == 0
    assert "solver.block" not in profiling.trace_record()["spans"]
    with profiling.tracing():
        x1, i1 = solvers.gmres(A, b, tol=0.0, rtol=RTOL, maxiter=20000, M=M)
    assert profiling.trace_record()["counters"]["solver"]["cycles"] == int(i1.iterations) // RESTART
    assert torch.equal(x0, x1) and torch.equal(i0.iterations, i1.iterations)
    assert torch.equal(i0.residual_norm, i1.residual_norm)
    profiling.reset_trace()


def step_roofline(monkeypatch, record):
    """``portbench/metrics/kernel.gmres_step_roofline.py`` over a made-up
    program whose trace record is ``record``."""
    import harness
    import programtrace

    mod = types.ModuleType(programtrace.MODULE)
    mod.trace_record = lambda: record
    monkeypatch.setitem(sys.modules, programtrace.MODULE, mod)
    return harness.load_module(os.path.join(BENCH, "metrics", "kernel.gmres_step_roofline.py"))


def test_step_roofline_reader(monkeypatch):
    # 40 committed steps over n = 10⁶ f32 rows: 500 basis rows projected
    # against; a SpMV bound of 0.1 ms; 50 ms of device time in the slice
    n, committed, rows = 10 ** 6, 40, 500
    record = {"spans": {}, "counters": {"solver": {
        "steps_executed": 60, "steps_committed": committed, "cycles": 2,
        "arnoldi_rows": rows, "arnoldi_bytes": rows * n * 4}}}
    run = {"kind": "solve", "bound_s": 1e-4,
           "slice": {"count": 9000, "device_s": 0.05}}
    floor = committed * 1e-4 + (2 * rows + committed) * n * 4 / 3.35e12
    got = step_roofline(monkeypatch, record).read(run)
    assert got == pytest.approx(100 * floor / 0.05, rel=1e-12)
    # a program with no GMRES counters, and a product cell, read nothing
    record["counters"]["solver"] = {"steps_executed": 60, "steps_committed": 40}
    assert step_roofline(monkeypatch, record).read(run) is None
    assert step_roofline(monkeypatch, record).read(dict(run, kind="product")) is None


@pytest.mark.parametrize("cell, overrides", [
    (CELL, {"grid": 12}),
    ("fem_pwtk.spmm8", {"n_nodes": 200, "bandwidth": 20}),
])
def test_harness_runs_the_cell_and_judges_it_correct(cell, overrides):
    import harness

    result, checks = harness.run(cell, 2**33 + 17, 0, 0, device="cpu",
                                 t_process=time.perf_counter(), overrides=overrides,
                                 count=int(harness.Cell(cell).traffic["sample"]))
    assert result["correct"] and result["failed"] == 0, checks
    assert {"setup_s"} < set(result["metrics"])


@pytest.mark.parametrize("control, traffic", [
    ("program bf16", {"maxiter": 120}),      # the program's own bfloat16 path
    ("reference bf16", {"maxiter": 120}),    # the plain reference in bfloat16
    ("program", {"rtol": 1e-4}),             # a solve stopped a decade short
])
def test_what_decides_correct_fails_the_controls(control, traffic):
    import harness
    from reference.system import ReferenceSystem
    from system import LoweredPortSystem

    system = {"program bf16": LoweredPortSystem("cpu", torch.bfloat16),
              "reference bf16": ReferenceSystem("cpu", torch.bfloat16),
              "program": None}[control]
    result, checks = harness.run(CELL, 2**33 + 17, 0, 0, device="cpu",
                                 t_process=time.perf_counter(), system=system,
                                 overrides={"grid": 12}, traffic_overrides=traffic, count=2)
    assert not result["correct"], checks
