"""The solver loop's blocks as one CUDA graph (``solvers._while``,
``_BlockGraph``): which loops qualify (``_eager_reason``), the loop's
bookkeeping around the graph, the ``solver`` counters of replays and
captures, and the benchmark's reader of them (``solver.graph_share``).

On the CPU no loop qualifies, so nothing is replayed.  The bookkeeping is
tested there through ``CpuReplay``, a block graph whose "replay" runs the
captured block op by op on the static buffers: the loading of a solve's
state and invariants, the capture after the first block, the copies handed
back, the cache on the operator, and that no body closes over a tensor of
the solve that captured it (a second solve with another b would then
replay the first one's).  On a card (``cuda`` marker) every case holds the
graphed loop bitwise to the op-by-op loop, which comes from patching
``_eager_reason``: x, ``iterations`` and ``residual_norm``."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import matgen, solvers
from sparsemat_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "portbench")
NOT_ON_A_CARD = "not on one CUDA card"


@pytest.fixture(autouse=True)
def fresh_trace():
    profiling.reset_trace()
    yield
    profiling.reset_trace()


def poisson(n):
    e = np.ones(n * n, dtype=np.float32)
    return sp.diags([4 * e, -e[1:], -e[1:], -e[n:], -e[n:]], [0, 1, -1, n, -n],
                    format="csr", dtype=np.float32)


def circuit(n):
    m = (matgen.circuit_scatter(n, seed=0) * 2e-2).astype(np.float32).tocsr()
    m.sort_indices()
    return m


def rhs(n, seed, device="cpu"):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(n).astype(np.float32)).to(device)


def solver_counts():
    return profiling.trace_record()["counters"]["solver"]


def same(a, b):
    """Two solves' (x, info) bitwise equal."""
    (xa, ia), (xb, ib) = a, b
    assert torch.equal(xa, xb)
    assert int(ia.iterations) == int(ib.iterations)
    assert torch.equal(ia.residual_norm, ib.residual_norm)
    assert bool(ia.converged) == bool(ib.converged)


# -- which loops qualify -------------------------------------------------------------------

class Sharded(torch.Tensor):
    """A tensor subclass in a DTensor's place (``parallel/``'s vectors)."""

    def full_tensor(self):
        return self.as_subclass(torch.Tensor)


def loop_operands(n=16):
    """An eligible loop's operands but for the device: a DIA, CG's state
    and invariants, on the CPU."""
    A = tsm.CSR.from_scipy(poisson(4)).to_dia()
    v = torch.zeros(n)
    state = dict(x=v, r=v.clone(), p=v.clone(), rz=torch.zeros(()), rr=torch.zeros(()),
                 k=torch.zeros((), dtype=torch.int32))
    consts = dict(maxiter=torch.tensor(9, dtype=torch.int32), thresh2=torch.zeros(()))
    return A, state, consts


def _callable(A, M, state, consts):
    return lambda v: v, M, state, consts


def _csr(A, M, state, consts):
    return A.to_csr(), M, state, consts


def _dtensor(A, M, state, consts):
    return A, M, dict(state, x=state["x"].as_subclass(Sharded)), consts


def _dtensor_invariant(A, M, state, consts):
    return A, M, state, dict(consts, b=torch.zeros(16).as_subclass(Sharded))


def _callable_preconditioner(A, M, state, consts):
    return A, (lambda r: r), state, consts


def _jacobi(A, M, state, consts):
    return A, solvers.JacobiPreconditioner.from_matrix(A), state, consts


EAGER_CASES = {
    # (change to the operands, on_step, every): the reason
    "cpu tensors": (None, None, solvers.SYNC_EVERY, NOT_ON_A_CARD),
    "cpu tensors with Jacobi": (_jacobi, None, solvers.SYNC_EVERY, NOT_ON_A_CARD),
    "record_history": (None, lambda active, new: None, solvers.SYNC_EVERY,
                       "a callback sees every step"),
    "every=1 (SOR)": (None, None, 1, "one step a block"),
    "a callable operator": (_callable, None, solvers.SYNC_EVERY,
                            "the operator's product is not a launch over a cached plan"),
    "a CSR operator": (_csr, None, solvers.SYNC_EVERY,
                       "the operator's product is not a launch over a cached plan"),
    "a callable preconditioner": (_callable_preconditioner, None, solvers.SYNC_EVERY,
                                  "a preconditioner of another kind"),
    "a DTensor state": (_dtensor, None, solvers.SYNC_EVERY, "a tensor subclass (DTensor)"),
    "a DTensor invariant": (_dtensor_invariant, None, solvers.SYNC_EVERY,
                            "a tensor subclass (DTensor)"),
}


@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_eager_reason_sends_the_input_to_the_op_by_op_loop(case):
    change, on_step, every, reason = EAGER_CASES[case]
    A, state, consts = loop_operands()
    M = None
    if change is not None:
        A, M, state, consts = change(A, M, state, consts)
    assert solvers._eager_reason(A, M, state, consts, on_step, every) == reason


@pytest.mark.parametrize("fmt", ["dia", "strip", "well", "slab", "slab_pack", "slab_stream",
                                 "route"])
def test_every_planned_format_qualifies_but_for_the_card(fmt):
    """The formats of ``_GRAPH_FORMATS`` pass every test but the card's."""
    _, state, consts = loop_operands()
    A = getattr(tsm.CSR.from_scipy(poisson(4)), f"to_{fmt}")()
    assert solvers._eager_reason(A, None, state, consts, None, solvers.SYNC_EVERY) \
        == NOT_ON_A_CARD


# -- on the CPU nothing is replayed ------------------------------------------------------------

def _cg(A, b, **kw):
    return solvers.cg(A, b, tol=0.0, **{"rtol": 1e-6, "maxiter": 2000, **kw})


def _chebyshev(A, b, **kw):
    return solvers.chebyshev(A, b, tol=0.0, **{"lambda_min": 0.05, "lambda_max": 8.0,
                                               "rtol": 1e-4, "maxiter": 2000, **kw})


def _jacobi_solve(A, b, **kw):
    return solvers.jacobi(A, b, tol=0.0, **{"rtol": 1e-2, "maxiter": 500, **kw})


def _bicgstab(A, b, **kw):
    return solvers.bicgstab(A, b, tol=0.0, **{"rtol": 1e-5, "maxiter": 2000, **kw})


def _jacobi_pre(A):
    return solvers.JacobiPreconditioner.from_matrix(A)


def _block_pre(A):
    return solvers.BlockJacobiPreconditioner.from_matrix(A, 16)


CPU_SOLVES = {
    # solver, the matrix, its format, the preconditioner's maker
    "cg": (_cg, lambda: poisson(16), "dia", None),
    "pcg jacobi": (_cg, lambda: poisson(16), "strip", _jacobi_pre),
    "pcg block jacobi": (_cg, lambda: poisson(16), "strip", _block_pre),
    "chebyshev": (_chebyshev, lambda: poisson(12), "dia", None),
    "jacobi": (_jacobi_solve, lambda: poisson(12), "dia", None),
    "bicgstab": (_bicgstab, lambda: circuit(3000), "route", None),
}


def case(cases, name, device="cpu"):
    """(solve(b, **kw), the operator, n): the case's solver over its
    operator, with one preconditioner object for all its solves."""
    solve, matrix, fmt, pre = cases[name]
    m = matrix()
    A = getattr(tsm.CSR.from_scipy(m, device=device), f"to_{fmt}")()
    pre_kw = {"M": pre(A)} if pre is not None else {}
    return (lambda b, **kw: solve(A, b, **pre_kw, **kw)), A, m.shape[0]


@pytest.mark.parametrize("name", list(CPU_SOLVES))
def test_cpu_solves_replay_nothing(name):
    solve, A, n = case(CPU_SOLVES, name)
    with profiling.tracing():
        _, info = solve(rhs(n, 1))
    c = solver_counts()
    assert int(info.iterations) > solvers.SYNC_EVERY
    assert c["steps_executed"] > solvers.SYNC_EVERY
    assert c["steps_replayed"] == 0 and c["graph_captures"] == 0
    assert "_solver_graphs" not in A.__dict__


# -- the bookkeeping, with a block graph that replays op by op ---------------------------------

def op_by_op(fn):
    """``fn()`` with the solver loops run op by op."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(solvers, "_eager_reason", lambda *a: "op by op")
        return fn()


class CpuReplay(solvers._BlockGraph):
    """A block graph whose replay runs the captured ``cond`` and ``body``
    op by op on the static buffers, as a CUDA graph replays the captured
    launches: so a body that held a tensor of the solve that captured it
    would replay that solve's tensor."""

    def capture(self, cond, body, every):
        self.captured = (cond, body, every)

    def replay(self):
        cond, body, every = self.captured
        out = solvers._block(cond, body, self.state, self.consts, every)
        for k, v in out.items():
            self.state[k].copy_(v)


def replaying(m):
    """Through ``m`` (a MonkeyPatch), loops that would qualify on a card run
    through ``CpuReplay``."""
    reason = solvers._eager_reason

    def on_cpu(*args):
        why = reason(*args)
        return None if why == NOT_ON_A_CARD else why

    m.setattr(solvers, "_eager_reason", on_cpu)
    m.setattr(solvers, "_BlockGraph", CpuReplay)


@pytest.fixture
def replay_on_cpu(monkeypatch):
    replaying(monkeypatch)


@pytest.mark.parametrize("name", list(CPU_SOLVES))
def test_replayed_loop_is_bitwise_the_op_by_op_loop(name, monkeypatch):
    solve, A, n = case(CPU_SOLVES, name)
    bs = [rhs(n, s) for s in (1, 2)]
    eager = [solve(b) for b in bs]
    with monkeypatch.context() as m:
        replaying(m)
        with profiling.tracing():
            replayed = [solve(b) for b in bs]
    for a, b in zip(replayed, eager):
        same(a, b)
    c = solver_counts()
    assert c["graph_captures"] == 1
    # the first solve's first block runs op by op; every other block replays
    assert c["steps_replayed"] == c["steps_executed"] - solvers.SYNC_EVERY > 0
    assert len(A.__dict__["_solver_graphs"]) == 1


def test_one_capture_serves_every_b_and_maxiter(replay_on_cpu):
    A = tsm.CSR.from_scipy(poisson(16)).to_dia()
    runs = [(1, 2000), (2, 45), (3, 33), (4, 2000), (5, 1)]
    with profiling.tracing():
        replayed = [_cg(A, rhs(256, s), maxiter=k) for s, k in runs]
    assert solver_counts()["graph_captures"] == 1
    assert [int(i.iterations) for _, i in replayed[1:3]] == [45, 33]
    for (s, k), got in zip(runs, replayed):
        same(got, op_by_op(lambda: _cg(A, rhs(256, s), maxiter=k)))


def test_answers_are_copies_that_later_solves_leave_alone(replay_on_cpu):
    A = tsm.CSR.from_scipy(poisson(16)).to_dia()
    x1, info1 = _cg(A, rhs(256, 1))
    kept = (x1.clone(), info1.iterations.clone(), info1.residual_norm.clone())
    (loop,) = A.__dict__["_solver_graphs"].values()
    statics = {t.data_ptr() for t in loop.state.values()}
    _cg(A, rhs(256, 2))
    x2, info2 = _cg(A, rhs(256, 3), maxiter=40)
    for t in (x1, info1.iterations, x2, info2.iterations):
        assert t.data_ptr() not in statics
    assert torch.equal(x1, kept[0]) and torch.equal(info1.iterations, kept[1])
    assert torch.equal(info1.residual_norm, kept[2])


def test_graphs_are_kept_by_solver_and_preconditioner_and_bounded(replay_on_cpu):
    A = tsm.CSR.from_scipy(poisson(12)).to_dia()
    b = rhs(144, 1)
    Ms = [solvers.JacobiPreconditioner.from_matrix(A) for _ in range(2)]
    _cg(A, b)
    _cg(A, b, M=Ms[0])
    _cg(A, b, M=Ms[1])                                  # another object: its own graph
    _cg(A, b, M=Ms[0])                                  # a known key
    assert len(A.__dict__["_solver_graphs"]) == 3
    for lo in (0.05, 0.06, 0.07):                       # the bounds are invariants
        _chebyshev(A, b, lambda_min=lo)
    assert len(A.__dict__["_solver_graphs"]) == 4
    _jacobi_solve(A, b)                                 # drops the least recently used
    graphs = A.__dict__["_solver_graphs"]
    assert len(graphs) == solvers.GRAPHS_PER_OPERATOR
    assert [k[0].co_qualname for k in graphs] == ["cg.<locals>.body", "cg.<locals>.body",
                                                  "chebyshev.<locals>.body",
                                                  "jacobi.<locals>.body"]
    assert [g.M for g in graphs.values()] == [Ms[1], Ms[0], None, None]


def test_one_chebyshev_graph_serves_every_bound(replay_on_cpu):
    A = tsm.CSR.from_scipy(poisson(12)).to_dia()
    bounds = [(0.05, 8.0), (0.1, 8.0), (0.05, 8.5)]
    with profiling.tracing():
        replayed = [_chebyshev(A, rhs(144, s), lambda_min=lo, lambda_max=hi)
                    for s, (lo, hi) in enumerate(bounds)]
    c = solver_counts()
    assert c["graph_captures"] == 1
    assert c["steps_replayed"] == c["steps_executed"] - solvers.SYNC_EVERY > 0
    for (s, (lo, hi)), got in zip(enumerate(bounds), replayed):
        same(got, op_by_op(lambda: _chebyshev(A, rhs(144, s), lambda_min=lo, lambda_max=hi)))


@pytest.mark.parametrize("name", list(CPU_SOLVES))
def test_a_solve_of_no_steps_after_a_capture_returns_its_start(name, replay_on_cpu):
    """maxiter = 0 on an operator that holds a graph runs no block: the
    answer is the solve's own x0, not the buffers' last state."""
    solve, A, n = case(CPU_SOLVES, name)
    solve(rhs(n, 1))
    assert len(A.__dict__["_solver_graphs"]) == 1
    x0 = rhs(n, 9)
    for kw in ({}, {"x0": x0}):
        got = solve(rhs(n, 2), maxiter=0, **kw)
        same(got, op_by_op(lambda: solve(rhs(n, 2), maxiter=0, **kw)))
        x, info = got
        assert int(info.iterations) == 0
        assert torch.equal(x, kw.get("x0", torch.zeros(n)))


def test_a_loop_done_in_its_first_block_captures_nothing(replay_on_cpu):
    A = tsm.CSR.from_scipy(poisson(16)).to_dia()
    with profiling.tracing():
        _cg(A, rhs(256, 1), maxiter=solvers.SYNC_EVERY)
    assert solver_counts()["graph_captures"] == 0
    assert not A.__dict__["_solver_graphs"]


# -- the benchmark's reader ----------------------------------------------------------------------

def graph_share(monkeypatch, record):
    """``portbench/metrics/solver.graph_share.py`` over a made-up program
    record (None: a program that keeps none)."""
    monkeypatch.syspath_prepend(BENCH)
    import programtrace

    mod = types.ModuleType(programtrace.MODULE)
    if record is not None:
        mod.trace_record = lambda: record
    monkeypatch.setitem(sys.modules, programtrace.MODULE, mod)
    spec = importlib.util.spec_from_file_location(
        "portbench_solver_graph_share", os.path.join(BENCH, "metrics", "solver.graph_share.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader


SOLVE = {"kind": "solve", "columns": 1}
PARENT = {"steps_executed": 4096, "steps_committed": 4080}


@pytest.mark.parametrize("record,run,value", [
    ({"spans": {}, "counters": {"solver": dict(PARENT, steps_replayed=4064,
                                               graph_captures=0)}}, SOLVE, 100 * 4064 / 4096),
    ({"spans": {}, "counters": {"solver": dict(PARENT, steps_replayed=4064)}},
     {"kind": "product", "columns": 1}, None),
    ({"spans": {}, "counters": {"solver": PARENT}}, SOLVE, None),     # no such counter
    ({"spans": {}, "counters": {"solver": {"steps_executed": 0, "steps_replayed": 0}}},
     SOLVE, None),
    ({"spans": {}, "counters": {}}, SOLVE, None),
    (None, SOLVE, None),
])
def test_graph_share_reader(monkeypatch, record, run, value):
    got = graph_share(monkeypatch, record).read(run)
    assert got == (pytest.approx(value) if value is not None else None)


# -- on the card ------------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_operator(m, fmt, device):
    return getattr(tsm.CSR.from_scipy(m, device=device), f"to_{fmt}")()


CARD_CASES = {
    # solver, the matrix, its format, the preconditioner's maker
    "cg dia 256²": (_cg, lambda: poisson(256), "dia", None),
    "cg dia 256² f64": (lambda A, b, **kw: _cg(A, b.double(), **{"rtol": 1e-8, **kw}),
                        lambda: poisson(256).astype(np.float64), "dia", None),
    "pcg jacobi strip": (_cg, lambda: poisson(64), "strip", _jacobi_pre),
    "pcg block jacobi strip": (_cg, lambda: poisson(64), "strip", _block_pre),
    "cg slab_stream": (_cg, lambda: poisson(64), "slab_stream", None),
    "bicgstab route": (_bicgstab, lambda: circuit(20_000), "route", None),
    "bicgstab well": (_bicgstab, lambda: circuit(20_000), "well", None),
    "chebyshev dia": (lambda A, b: _chebyshev(A, b, lambda_min=0.004, maxiter=3000),
                      lambda: poisson(64), "dia", None),
    "jacobi dia": (_jacobi_solve, lambda: poisson(32), "dia", None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_cuda_graphed_loop_is_bitwise_the_op_by_op_loop(cuda, name):
    solve, A, n = case(CARD_CASES, name, cuda)
    b = rhs(n, 7, cuda)
    with profiling.tracing():
        graphed = [solve(b) for _ in range(2)]          # captures, then replays whole
    c = solver_counts()
    assert c["graph_captures"] == 1 and c["steps_replayed"] > 0
    eager = op_by_op(lambda: solve(b))
    for got in graphed:
        same(got, eager)
    assert int(eager[1].iterations) > solvers.SYNC_EVERY


@pytest.mark.cuda
def test_cuda_one_capture_serves_every_b_and_maxiter(cuda):
    A = card_operator(poisson(128), "dia", cuda)
    runs = [(1, 2000), (2, 100), (3, 2000), (4, 45)]
    with profiling.tracing():
        graphed = [_cg(A, rhs(128 * 128, s, cuda), maxiter=k) for s, k in runs]
    c = solver_counts()
    assert c["graph_captures"] == 1
    assert c["steps_replayed"] == c["steps_executed"] - solvers.SYNC_EVERY
    for (s, k), got in zip(runs, graphed):
        same(got, op_by_op(lambda: _cg(A, rhs(128 * 128, s, cuda), maxiter=k)))
    assert [int(i.iterations) for _, i in graphed[1::2]] == [100, 45]


@pytest.mark.cuda
def test_cuda_first_answer_survives_a_second_solve(cuda):
    A = card_operator(circuit(20_000), "route", cuda)
    x1, info1 = _bicgstab(A, rhs(20_000, 1, cuda))
    kept = (x1.clone(), info1.iterations.clone(), info1.residual_norm.clone())
    x2, _ = _bicgstab(A, rhs(20_000, 2, cuda))
    torch.cuda.synchronize()
    assert torch.equal(x1, kept[0]) and torch.equal(info1.iterations, kept[1])
    assert torch.equal(info1.residual_norm, kept[2])
    assert not torch.equal(x1, x2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cg dia 256²", "bicgstab route"])
def test_cuda_a_solve_of_no_steps_after_a_capture_returns_its_start(cuda, name):
    solve, A, n = case(CARD_CASES, name, cuda)
    solve(rhs(n, 1, cuda))
    assert len(A.__dict__["_solver_graphs"]) == 1
    x0 = rhs(n, 9, cuda)
    for kw in ({}, {"x0": x0}):
        x, info = solve(rhs(n, 2, cuda), maxiter=0, **kw)
        assert int(info.iterations) == 0
        assert torch.equal(x, kw.get("x0", torch.zeros(n, device=cuda)))


@pytest.mark.cuda
def test_cuda_solves_on_two_streams_at_once_share_no_buffers(cuda):
    """Two threads, each on a stream of its own, solve on one operator at
    once: each stream has its graph, and each answer is bitwise its solve's
    op-by-op answer."""
    import threading

    A = card_operator(poisson(128), "dia", cuda)
    n = 128 * 128
    bs = [rhs(n, s, cuda) for s in (1, 2)]
    want = [op_by_op(lambda b=b: _cg(A, b)) for b in bs]
    streams = [torch.cuda.Stream(cuda) for _ in bs]
    for stream, b in zip(streams, bs):                  # one capture at a time
        with torch.cuda.stream(stream):
            _cg(A, b)
        stream.synchronize()
    assert len(A.__dict__["_solver_graphs"]) == 2
    got = [[], []]

    def solves(i):
        with torch.cuda.stream(streams[i]):
            for _ in range(4):
                got[i].append(_cg(A, bs[i]))
        streams[i].synchronize()

    threads = [threading.Thread(target=solves, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(A.__dict__["_solver_graphs"]) == 2
    for i in range(2):
        assert len(got[i]) == 4
        for answer in got[i]:
            same(answer, want[i])
