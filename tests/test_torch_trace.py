"""The port's spans and counters (``utils/profiling.py``): free when tracing
is off, host ranges named ``sparsemat.*`` under ``torch.profiler``, a table
of counts and self times that adds up, the ``tracing()`` switch, the
solver loop's step counters, the dispatch's conversion counter, the set-up
spans of a freeze, and the one registry of counters that holds the
launch groups (``kernels.dia``, ``kernels.plan``, ``kernels.spmm_lanes``,
``parallel.dist``)."""

import contextlib
import itertools
import math
import tracemalloc

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import solvers
from sparsemat_tpu_torch.kernels import _rowgroup
from sparsemat_tpu_torch.kernels import dia as kdia
from sparsemat_tpu_torch.kernels import krylov
from sparsemat_tpu_torch.parallel import dist as pdist
from sparsemat_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_trace():
    profiling.reset_trace()
    yield
    profiling.reset_trace()


def poisson(n):
    e = np.ones(n * n, dtype=np.float32)
    return sp.diags([4 * e, -e[1:], -e[1:], -e[n:], -e[n:]], [0, 1, -1, n, -n],
                    format="csr", dtype=np.float32)


def fem_band(n_rows=192, seed=0, heavy=False):
    """A symmetric band of scattered entries that ``to_strip`` takes; with
    ``heavy``, one row full across the band, so padding every row to the
    longest is too wasteful for the ELL gather (as on the FEM operator,
    whose (rows, longest, columns) gather is too large)."""
    rng = np.random.default_rng(seed)
    m = sp.random(n_rows, n_rows, 0.05, format="lil", random_state=rng, dtype=np.float32)
    if heavy:
        m[n_rows // 2, n_rows // 2 - 28:n_rows // 2 + 28] = 1.0
    m = sp.csr_matrix(m)
    m = sp.triu(m, -40) - sp.triu(m, 41)
    m = m + m.T + sp.eye(n_rows, dtype=np.float32) * 8
    return sp.csr_matrix(m, dtype=np.float32)


def conversions():
    """The dispatch's conversions by target, those never made (or reset to
    zero) left out."""
    return {k: n for k, n in profiling.trace_record()["counters"]["ops.conversions"].items()
            if n}


def sparsemat_ranges(prof):
    return [e.name for e in prof.events() if e.name.startswith("sparsemat.")]


# -- off ---------------------------------------------------------------------------------

def test_span_off_is_one_shared_noop_that_records_nothing():
    assert not profiling.on()
    a, b = profiling.span("ops.spmv"), profiling.span("solver.block")
    assert a is b
    with a:
        with b:
            pass
    assert profiling.trace_record()["spans"] == {}


def test_span_off_enters_no_record_function_and_allocates_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")

    monkeypatch.setattr(profiling, "_record_function", refuse)
    def loop(n, body):
        for _ in itertools.repeat(None, n):
            with body():
                pass

    def peak(body):
        """Bytes allocated at the loop's peak, over what it started with."""
        loop(1000, body)                    # warm: the interpreter specialises the loop
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            loop(1000, body)
            return tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()

    shared = contextlib.nullcontext()
    assert peak(lambda: profiling.span("ops.spmv")) == peak(lambda: shared)


def test_spans_off_leave_no_range_in_a_profiler_started_afterwards():
    A = tsm.CSR.from_scipy(poisson(6))
    x = torch.ones(36)
    tsm.spmv(A, x)
    with profiling.span("freeze.plan"):
        pass
    with torch.profiler.profile() as prof:
        torch.ones(4).add_(1)
    assert sparsemat_ranges(prof) == []
    assert profiling.trace_record()["spans"] == {}


# -- on ----------------------------------------------------------------------------------

def test_spans_are_host_ranges_under_the_profiler():
    A = tsm.CSR.from_scipy(poisson(6))
    with torch.profiler.profile() as prof:
        with profiling.span("outer"):
            tsm.spmv(A, torch.ones(36))
    names = sparsemat_ranges(prof)
    assert names.count("sparsemat.outer") == 1
    assert names.count("sparsemat.ops.spmv") == 1
    spans = profiling.trace_record()["spans"]
    assert spans["outer"]["count"] == spans["ops.spmv"]["count"] == 1
    assert not profiling.on()


def test_nested_spans_add_up():
    with profiling.tracing():
        for _ in range(3):
            with profiling.span("outer"):
                for _ in range(2):
                    with profiling.span("inner"):
                        sum(range(2000))
                sum(range(2000))
    spans = profiling.trace_record()["spans"]
    outer, inner = spans["outer"], spans["inner"]
    assert (outer["count"], inner["count"]) == (3, 6)
    assert inner["self_s"] == pytest.approx(inner["total_s"])
    assert outer["self_s"] + inner["total_s"] == pytest.approx(outer["total_s"])
    assert 0 < outer["self_s"] < outer["total_s"]


def test_tracing_turns_the_table_on_without_a_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "_record_function",
                        lambda name: pytest.fail("no profiler records"))
    A = tsm.CSR.from_scipy(poisson(6))
    with profiling.tracing():
        assert profiling.on()
        with profiling.tracing():
            tsm.spmv(A, torch.ones(36))
        assert profiling.on()
        tsm.spmv(A, torch.ones(36))
    assert not profiling.on()
    tsm.spmv(A, torch.ones(36))
    assert profiling.trace_record()["spans"]["ops.spmv"]["count"] == 2


def test_trace_record_is_a_copy_and_reset_clears_it():
    with profiling.tracing():
        with profiling.span("a"):
            pass
        profiling.count(profiling.CONVERSIONS, "csr", 2)
    rec = profiling.trace_record()
    rec["spans"]["a"]["count"] = 99
    rec["counters"]["ops.conversions"]["csr"] = 99
    again = profiling.trace_record()
    assert again["spans"]["a"]["count"] == 1
    assert again["counters"]["ops.conversions"] == {"csr": 2}
    profiling.reset_trace()
    rec = profiling.trace_record()
    assert rec["spans"] == {}
    assert all(v == 0 for c in rec["counters"].values() for v in c.values())


# -- the solver loop ---------------------------------------------------------------------

SOLVES = {
    "cg": lambda A, b: solvers.cg(A, b, tol=0.0, rtol=1e-5),
    "bicgstab": lambda A, b: solvers.bicgstab(A, b, tol=0.0, rtol=1e-5),
    "jacobi": lambda A, b: solvers.jacobi(A, b, tol=0.0, rtol=1e-2, maxiter=500),
    "chebyshev": lambda A, b: solvers.chebyshev(A, b, lambda_min=0.05, lambda_max=8.0,
                                                tol=0.0, rtol=1e-4),
    "sor": lambda A, b: solvers.sor(A, b, omega=1.5, tol=0.0, rtol=1e-4),
}


@pytest.mark.parametrize("solver", list(SOLVES))
def test_steps_executed_and_committed(solver):
    A = tsm.auto_format(tsm.CSR.from_scipy(poisson(12)))
    if solver == "sor":
        A = A.to_csr()
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(144).astype(np.float32))
    with profiling.tracing():
        _, info = SOLVES[solver](A, b)
    rec = profiling.trace_record()
    every = 1 if solver == "sor" else solvers.SYNC_EVERY
    iters = int(info.iterations)
    blocks = rec["spans"]["solver.block"]["count"]
    assert bool(info.converged) and iters > 0
    assert blocks == math.ceil(iters / every)
    # on the CPU the loop runs op by op: nothing replayed, nothing captured
    assert rec["counters"]["solver"] == {"steps_executed": every * blocks,
                                         "steps_committed": iters, "steps_replayed": 0,
                                         "steps_fused": 0, "graph_captures": 0, "cycles": 0,
                                         "arnoldi_rows": 0, "arnoldi_bytes": 0}


def test_solver_counts_nothing_with_tracing_off():
    A = tsm.auto_format(tsm.CSR.from_scipy(poisson(12)))
    solvers.cg(A, torch.ones(144), tol=0.0, rtol=1e-5)
    rec = profiling.trace_record()
    assert "solver.block" not in rec["spans"]
    assert rec["counters"]["solver"] == {"steps_executed": 0, "steps_committed": 0,
                                         "steps_replayed": 0, "steps_fused": 0,
                                         "graph_captures": 0, "cycles": 0, "arnoldi_rows": 0,
                                         "arnoldi_bytes": 0}


# -- the dispatch ------------------------------------------------------------------------

@pytest.mark.parametrize("heavy,expected", [(True, {"csr": 3}), (False, {"csr": 3, "ell": 3})])
def test_strip_spmm_counts_its_conversions_a_call(heavy, expected):
    """One a call (to CSR) where the CSR's column-tiled stream follows, as on
    the FEM operator; two where its ELL gather does."""
    m = fem_band(heavy=heavy)
    st = tsm.CSR.from_scipy(m).to_strip()
    assert isinstance(st, tsm.StripELL)
    B = torch.from_numpy(np.random.default_rng(2).standard_normal((192, 8)).astype(np.float32))
    with torch.profiler.profile() as prof:
        for _ in range(3):
            Y = tsm.spmm(st, B)
    np.testing.assert_allclose(Y.numpy(), m @ B.numpy(), rtol=1e-4, atol=1e-4)
    rec = profiling.trace_record()
    assert conversions() == expected
    assert rec["spans"]["ops.spmm"]["count"] == 3          # the outermost call only
    assert sparsemat_ranges(prof).count("sparsemat.ops.spmm") == 3


def test_dia_spmv_counts_no_conversion():
    A = tsm.auto_format(tsm.CSR.from_scipy(poisson(8)))
    assert isinstance(A, tsm.DIA)
    with profiling.tracing():
        for _ in range(4):
            tsm.spmv(A, torch.ones(64))
        tsm.spmv_dot(A, torch.ones(64))                     # no span of its own
    rec = profiling.trace_record()
    assert conversions() == {}
    assert rec["spans"]["ops.spmv"]["count"] == 4


@pytest.mark.parametrize("method,target", [("dia", "dia"), ("ell", "ell"), ("gell", "gell")])
def test_method_conversions_are_counted_by_target(method, target):
    A = tsm.CSR.from_scipy(poisson(6))
    with profiling.tracing():
        y = tsm.spmv(A, torch.ones(36), method=method)
    np.testing.assert_allclose(y.numpy(), poisson(6) @ np.ones(36), rtol=1e-6)
    assert conversions() == {target: 1}


def test_spmv_fallback_through_coo_is_counted():
    A = tsm.CSR.from_scipy(poisson(6)).to_sell()
    with profiling.tracing():
        tsm.spmv(A, torch.ones(36))
        tsm.spmv(A.to_coo(), torch.ones(36))                 # a COO is not converted
    assert conversions() == {"coo": 1}


# -- set-up spans ------------------------------------------------------------------------

def test_auto_format_records_with_tracing_off():
    assert not profiling.on()
    tsm.auto_format(tsm.CSR.from_scipy(poisson(8)))
    tsm.auto_format(tsm.CSR.from_scipy(fem_band()))
    s = profiling.trace_record()["spans"]["freeze.auto_format"]
    assert s["count"] == 2 and s["total_s"] > 0


def test_plan_build_records_with_tracing_off_once_a_matrix():
    st = tsm.CSR.from_scipy(fem_band()).to_strip()
    assert not profiling.on()
    plan = _rowgroup.plan_of(st)
    assert _rowgroup.plan_of(st) is plan                     # cached: no second build
    s = profiling.trace_record()["spans"]["freeze.plan"]
    assert s["count"] == 1 and s["self_s"] == pytest.approx(s["total_s"])


def test_plan_self_time_leaves_a_nested_build_out():
    with profiling.span("freeze.plan", setup=True):
        with profiling.span("freeze.build", setup=True):
            sum(range(20000))
    spans = profiling.trace_record()["spans"]
    plan, build = spans["freeze.plan"], spans["freeze.build"]
    assert plan["self_s"] == pytest.approx(plan["total_s"] - build["total_s"])
    assert plan["self_s"] < build["total_s"]


# -- the registry ------------------------------------------------------------------------

def test_the_registry_holds_the_seven_launch_dicts():
    reg = profiling.COUNTERS
    # five groups: the DIA kernels, every launch over a row-group plan (the
    # seven formats' products), the row-group SpMM's launches by lane width,
    # the shard products and CG's step kernels
    mods = {"kernels.dia": kdia, "kernels.plan": _rowgroup, "parallel.dist": pdist,
            "kernels.krylov": krylov}
    for name, mod in mods.items():
        assert reg[name] is mod.LAUNCHES, name
    assert reg["kernels.spmm_lanes"] is _rowgroup.LANE_LAUNCHES
    assert set(reg) == set(mods) | {"kernels.spmm_lanes", "solver", "ops.conversions"}


def test_launch_counts_keep_their_behaviour():
    kdia.LAUNCHES["dia_spmv"] += 5                           # counted whatever tracing does
    assert profiling.trace_record()["counters"]["kernels.dia"]["dia_spmv"] == 5
    kdia.reset_launches()
    assert kdia.LAUNCHES["dia_spmv"] == 0
    assert profiling.COUNTERS["kernels.dia"] is kdia.LAUNCHES
