"""Unpreconditioned CG's step kernels (``kernels/krylov.py``,
``csrc/krylov.cu``), which commit each step themselves under the device's
active flag.

On the CPU: where ``solvers.cg`` runs them (``_fused_reason``: never on the
CPU, for bf16, for a DTensor-like subclass, with a preconditioner or a
history), the ``solver`` counter ``steps_fused`` those solves leave at 0,
the loop's bookkeeping for a body that commits itself (``_commits_itself``,
op by op and through a block graph that replays op by op), and the
benchmark's reader ``solver.fused_share``.  On a card (``cuda`` marker): the
fused solve against the body of PyTorch ops on the same card, f32 and f64,
bitwise reruns, the state of a solve that converges inside a block, the
caller's b and x0, and the counter."""

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
from sparsemat_tpu_torch import solvers
from sparsemat_tpu_torch.kernels import krylov
from sparsemat_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "portbench")


@pytest.fixture(autouse=True)
def fresh_trace():
    profiling.reset_trace()
    yield
    profiling.reset_trace()


def poisson(n, dtype=np.float32):
    e = np.ones(n * n, dtype=dtype)
    return sp.diags([4 * e, -e[1:], -e[1:], -e[n:], -e[n:]], [0, 1, -1, n, -n],
                    format="csr", dtype=dtype)


def rhs(n, seed, device="cpu", dtype=torch.float32):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(n)).to(device=device, dtype=dtype)


def solver_counts():
    return profiling.trace_record()["counters"]["solver"]


class Sharded(torch.Tensor):
    """A tensor subclass in a DTensor's place (``parallel/``'s vectors)."""

    def full_tensor(self):
        return self.as_subclass(torch.Tensor)


# -- which solves fuse ---------------------------------------------------------------------

def _dia(dtype=np.float32):
    return tsm.CSR.from_scipy(poisson(8, dtype)).to_dia()


def _plain(A):
    return dict(A=A, b=rhs(64, 1))


def _bf16(A):
    return dict(A=A.astype(torch.bfloat16), b=rhs(64, 1, dtype=torch.bfloat16))


def _subclass(A):
    return dict(A=A, b=rhs(64, 1).as_subclass(Sharded))


def _jacobi(A):
    return dict(A=A, b=rhs(64, 1), M=solvers.JacobiPreconditioner.from_matrix(A))


def _history(A):
    return dict(A=A, b=rhs(64, 1), record_history=True)


NOT_FUSED = {
    # the solve's operands: the reason
    "the CPU": (_plain, "not on one CUDA card"),
    "bf16": (_bf16, "not one dtype of float32 or float64"),
    "a DTensor-like subclass": (_subclass, "a tensor subclass (DTensor)"),
    "a preconditioner": (_jacobi, "a preconditioner"),
    "record_history": (_history, "a callback sees every step"),
}


def reason_of(kw):
    """``_fused_reason`` as ``cg`` asks it: b, its x0 and r = b − A·x0."""
    b = torch.as_tensor(kw["b"])
    x = torch.zeros_like(b)
    r = b - tsm.spmv(kw["A"], x)
    return solvers._fused_reason(b, x, r, kw.get("M"), kw.get("record_history", False))


@pytest.mark.parametrize("case", list(NOT_FUSED))
def test_fused_reason_names_why_cg_keeps_its_selects(case):
    make, reason = NOT_FUSED[case]
    assert reason_of(make(_dia())) == reason


@pytest.mark.parametrize("case", ["f16", "mixed f32 and f64"])
def test_fused_reason_takes_one_dtype_of_the_kernels(case):
    b = rhs(64, 1, dtype=torch.float16 if case == "f16" else torch.float32)
    r = b.to(torch.float64) if case != "f16" else b
    assert solvers._fused_reason(b, torch.zeros_like(b), r, None, False) \
        == "not one dtype of float32 or float64"


@pytest.mark.parametrize("case", list(NOT_FUSED))
def test_cpu_solves_fuse_no_step(case):
    kw = NOT_FUSED[case][0](_dia())
    A, b = kw.pop("A"), kw.pop("b")
    with profiling.tracing():
        _, info = solvers.cg(A, b, tol=0.0, rtol=1e-4, maxiter=500, **kw)
    c = solver_counts()
    assert bool(info.converged) and int(info.iterations) > 0
    assert c["steps_executed"] > 0 and c["steps_fused"] == 0


# -- the loop's bookkeeping for a body that commits itself ----------------------------------

def halving_loop(n=16):
    """A loop that halves rr and adds 1 to x each step until rr < thresh2:
    its cond, a body of selects, a body that commits itself in place, and
    the state and invariants."""
    def cond(s, c):
        return (s["k"] < c["maxiter"]) & (s["rr"] >= c["thresh2"])

    def body(s, c):
        return dict(x=s["x"] + 1, rr=s["rr"] / 2, k=s["k"] + 1)

    @solvers._commits_itself
    def committing(s, c):
        active = cond(s, c)
        s["x"].add_(active.to(s["x"].dtype))
        s["rr"].div_(torch.where(active, 2.0, 1.0))
        s["k"].add_(active.to(torch.int32))
        return s

    def state():
        return dict(x=torch.zeros(n), rr=torch.tensor(2.0 ** 40),
                    k=torch.zeros((), dtype=torch.int32))

    consts = dict(maxiter=torch.tensor(1000, dtype=torch.int32), thresh2=torch.tensor(1.0))
    return cond, body, committing, state, consts


def test_a_body_that_commits_itself_runs_with_no_select():
    cond, body, committing, state, consts = halving_loop()
    assert not hasattr(body, "commits")
    s0 = state()
    calls = []

    @solvers._commits_itself
    def counted(s, c):
        calls.append(s)
        return committing(s, c)

    out = solvers._block(cond, counted, s0, consts, 5)
    assert out is s0 and len(calls) == 5 and all(s is s0 for s in calls)
    assert int(out["k"]) == 5 and torch.equal(out["x"], torch.full((16,), 5.0))


def test_a_body_that_commits_itself_freezes_where_cond_fails_and_counts_its_steps():
    cond, body, committing, state, consts = halving_loop()
    want = solvers._while(cond, body, state(), consts, 1000)
    with profiling.tracing():
        got = solvers._while(cond, committing, state(), consts, 1000)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert int(got["k"]) == 41                       # 2^40 halved to 1/2, not past it
    c = solver_counts()
    assert c["steps_fused"] == c["steps_executed"] == 2 * solvers.SYNC_EVERY
    assert c["steps_committed"] == 41


class CpuReplay(solvers._BlockGraph):
    """A block graph whose replay runs the captured block op by op on the
    static buffers, and copies back only what the block did not write in
    place, as ``_BlockGraph.capture`` does."""

    def capture(self, cond, body, every):
        self.captured = (cond, body, every)
        self.copies = 0

    def replay(self):
        cond, body, every = self.captured
        out = solvers._block(cond, body, self.state, self.consts, every)
        for k, v in out.items():
            if v is not self.state[k]:
                self.state[k].copy_(v)
                self.copies += 1


def test_a_replayed_body_that_commits_itself_writes_the_graphs_buffers(monkeypatch):
    cond, body, committing, state, consts = halving_loop()
    A = tsm.CSR.from_scipy(poisson(4)).to_dia()
    want = solvers._while(cond, body, state(), consts, 1000)
    monkeypatch.setattr(solvers, "_eager_reason", lambda *a: None)
    monkeypatch.setattr(solvers, "_BlockGraph", CpuReplay)
    with profiling.tracing():
        got = [solvers._while(cond, committing, state(), consts, 1000, A=A) for _ in range(2)]
    (loop,) = A.__dict__["_solver_graphs"].values()
    assert loop.copies == 0
    for out in got:
        for key in want:
            assert torch.equal(out[key], want[key]), key
            assert out[key].data_ptr() != loop.state[key].data_ptr()
    c = solver_counts()
    assert c["graph_captures"] == 1
    assert c["steps_fused"] == c["steps_executed"] == 4 * solvers.SYNC_EVERY
    assert c["steps_replayed"] == 3 * solvers.SYNC_EVERY


def torch_step(x, r, p, Ap, pAp, rr, k, maxiter, thresh2):
    """``krylov.cg_step``'s plain version: ``cg``'s body of PyTorch ops and
    selects with z = r, as new tensors (x, r, p, rr, k)."""
    active = (k < maxiter) & (rr >= thresh2)
    alpha = torch.where(pAp != 0, rr / pAp, 0)
    x1, r1 = x + alpha * p, r - alpha * Ap
    rr1 = solvers._dot(r1, r1)
    beta = torch.where(rr != 0, rr1 / rr, 0)
    new = dict(x=x1, r=r1, p=r1 + beta * p, rr=rr1, k=k + 1)
    old = dict(x=x, r=r, p=p, rr=rr, k=k)
    return {key: torch.where(active, new[key], old[key]) for key in new}


def test_a_fused_solve_takes_one_scratch_and_hands_it_to_every_step(monkeypatch):
    """The fused body's plumbing, with the kernels' launch in PyTorch: one
    ``step_scratch`` a solve, kept among the loop's invariants and given to
    every step, and the solve's answer bitwise the body of selects'."""
    A, b = tsm.CSR.from_scipy(poisson(16)).to_dia(), rhs(256, 4)
    want, want_info = solvers.cg(A, b, tol=0.0, rtol=1e-6)
    made, seen = [], set()

    def scratch(device):
        made.append((torch.zeros(8, dtype=torch.float64), torch.zeros(1, dtype=torch.int32)))
        return made[-1]

    def step(x, r, p, Ap, pAp, rr, k, maxiter, thresh2, work, counter):
        seen.add((id(work), id(counter)))
        for t, v in zip((x, r, p, rr, k), torch_step(x, r, p, Ap, pAp, rr, k, maxiter,
                                                     thresh2).values()):
            t.copy_(v)

    monkeypatch.setattr(solvers, "_fused_reason", lambda *a: None)
    monkeypatch.setattr(krylov, "step_scratch", scratch)
    monkeypatch.setattr(krylov, "cg_step", step)
    with profiling.tracing():
        got, info = solvers.cg(A, b, tol=0.0, rtol=1e-6)
    assert len(made) == 1 and seen == {tuple(map(id, made[0]))}
    assert torch.equal(got, want) and torch.equal(info.iterations, want_info.iterations)
    c = solver_counts()
    assert c["steps_fused"] == c["steps_executed"] > solvers.SYNC_EVERY


# -- the benchmark's reader ----------------------------------------------------------------------

def fused_share(monkeypatch, record):
    """``portbench/metrics/solver.fused_share.py`` over a made-up program
    record (None: a program that keeps none)."""
    monkeypatch.syspath_prepend(BENCH)
    import programtrace

    mod = types.ModuleType(programtrace.MODULE)
    if record is not None:
        mod.trace_record = lambda: record
    monkeypatch.setitem(sys.modules, programtrace.MODULE, mod)
    spec = importlib.util.spec_from_file_location(
        "portbench_solver_fused_share", os.path.join(BENCH, "metrics", "solver.fused_share.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    return reader


SOLVE = {"kind": "solve", "columns": 1}
PARENT = {"steps_executed": 4224, "steps_committed": 4221, "steps_replayed": 4224,
          "graph_captures": 0}


@pytest.mark.parametrize("record,run,value", [
    ({"spans": {}, "counters": {"solver": dict(PARENT, steps_fused=4224)}}, SOLVE, 100.0),
    ({"spans": {}, "counters": {"solver": dict(PARENT, steps_fused=1056)}}, SOLVE, 25.0),
    ({"spans": {}, "counters": {"solver": dict(PARENT, steps_fused=0)}}, SOLVE, 0.0),
    ({"spans": {}, "counters": {"solver": dict(PARENT, steps_fused=4224)}},
     {"kind": "product", "columns": 1}, None),
    ({"spans": {}, "counters": {"solver": PARENT}}, SOLVE, None),      # the parent's program
    ({"spans": {}, "counters": {"solver": {"steps_executed": 0, "steps_fused": 0}}},
     SOLVE, None),
    ({"spans": {}, "counters": {}}, SOLVE, None),
    (None, SOLVE, None),
])
def test_fused_share_reader(monkeypatch, record, run, value):
    got = fused_share(monkeypatch, record).read(run)
    assert got == (pytest.approx(value) if value is not None else None)


# -- on the card ------------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_dia(n, dtype, device):
    return tsm.CSR.from_scipy(poisson(n, dtype), device=device).to_dia()


def unfused(fn):
    """``fn()`` with ``cg`` sent to its body of PyTorch ops and selects."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(solvers, "_fused_reason", lambda *a: "the body of torch ops")
        return fn()


DTYPES = {"f32": (np.float32, torch.float32, 1e-5), "f64": (np.float64, torch.float64, 1e-8)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_fused_cg_matches_the_body_of_torch_ops(cuda, dtype):
    np_dt, dt, rtol = DTYPES[dtype]
    A = card_dia(256, np_dt, cuda)
    b = rhs(256 * 256, 7, cuda, dt)
    with profiling.tracing():
        x, info = solvers.cg(A, b, tol=0.0, rtol=rtol, maxiter=5000)
    c = solver_counts()
    assert c["steps_fused"] == c["steps_executed"] > 0
    profiling.reset_trace()
    with profiling.tracing():
        xp, infop = unfused(lambda: solvers.cg(A, b, tol=0.0, rtol=rtol, maxiter=5000))
    assert solver_counts()["steps_fused"] == 0
    assert x.dtype == xp.dtype == dt
    assert bool(info.converged) and bool(infop.converged)
    k, kp = int(info.iterations), int(infop.iterations)
    assert k > solvers.SYNC_EVERY and abs(k - kp) <= 0.03 * kp
    assert float(torch.linalg.vector_norm(x - xp) / torch.linalg.vector_norm(xp)) <= 1e-4


@pytest.mark.cuda
def test_cuda_fused_reruns_are_bitwise_equal(cuda):
    b = rhs(128 * 128, 3, cuda)
    A, fresh = card_dia(128, np.float32, cuda), card_dia(128, np.float32, cuda)
    runs = [solvers.cg(M, b, tol=0.0, rtol=1e-5) for M in (A, A, fresh, A)]
    for x, info in runs[1:]:
        assert torch.equal(x, runs[0][0])
        assert torch.equal(info.iterations, runs[0][1].iterations)
        assert torch.equal(info.residual_norm, runs[0][1].residual_norm)


@pytest.mark.cuda
def test_cuda_a_solve_that_converges_inside_a_block_keeps_its_last_active_step(cuda,
                                                                               monkeypatch):
    """The state a converged solve returns (x, r, p, rr, k) is bitwise the
    state of the same solve stopped by ``maxiter`` at its iteration count:
    the steps after convergence in its last block commit nothing."""
    loops = []
    run_loop = solvers._while

    def kept(*args, **kw):
        out = run_loop(*args, **kw)
        loops.append(out)
        return out

    monkeypatch.setattr(solvers, "_while", kept)
    A = card_dia(128, np.float32, cuda)
    b = rhs(128 * 128, 5, cuda)
    counts = []
    for rtol in (1e-3, 1e-4, 1e-5):
        _, info = solvers.cg(A, b, tol=0.0, rtol=rtol, maxiter=5000)
        k = int(info.iterations)
        counts.append(k)
        solvers.cg(A, b, tol=0.0, rtol=0.0, maxiter=k)
        converged, stopped = loops[-2:]
        assert set(converged) == set(stopped) == {"x", "r", "p", "rr", "k"}
        for key in converged:
            assert torch.equal(converged[key], stopped[key]), (rtol, key)
    assert any(k % solvers.SYNC_EVERY for k in counts)


@pytest.mark.cuda
def test_cuda_the_callers_b_and_x0_come_out_unchanged(cuda):
    A = card_dia(128, np.float32, cuda)
    b, x0 = rhs(128 * 128, 1, cuda), rhs(128 * 128, 2, cuda)
    kept = b.clone(), x0.clone()
    for _ in range(2):                                  # op by op, then replayed
        x, info = solvers.cg(A, b, x0, tol=0.0, rtol=1e-5)
        assert bool(info.converged) and x.data_ptr() != x0.data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(b, kept[0]) and torch.equal(x0, kept[1])


@pytest.mark.cuda
def test_cuda_steps_fused_counts_every_executed_step(cuda):
    A = card_dia(128, np.float32, cuda)
    with profiling.tracing():
        for s in (1, 2):
            solvers.cg(A, rhs(128 * 128, s, cuda), tol=0.0, rtol=1e-5)
    c = solver_counts()
    assert c["steps_fused"] == c["steps_executed"] > c["steps_replayed"] > 0
    assert c["graph_captures"] == 1
    # the launches of the op-by-op block and of the capture; a replay adds none
    assert krylov.LAUNCHES == {"cg_update": 2 * solvers.SYNC_EVERY,
                               "cg_direction": 2 * solvers.SYNC_EVERY}


@pytest.mark.cuda
def test_cuda_pcg_keeps_its_selects(cuda):
    A = card_dia(64, np.float32, cuda)
    M = solvers.JacobiPreconditioner.from_matrix(A)
    with profiling.tracing():
        _, info = solvers.cg(A, rhs(64 * 64, 1, cuda), tol=0.0, rtol=1e-5, M=M)
    c = solver_counts()
    assert bool(info.converged)
    assert c["steps_executed"] > 0 and c["steps_fused"] == 0


STEP_CASES = {
    # the state's changes from a random active one: (k, maxiter, thresh2 as a share of rr, pAp)
    "active": (0, 10, 0.5, None),
    "k at maxiter": (10, 10, 0.5, None),
    "rr under thresh2": (0, 10, 2.0, None),
    "breakdown pAp = 0": (0, 10, 0.5, 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_cg_step_is_the_torch_step(cuda, dtype, case):
    """One launch pair against ``torch_step`` on the same random state:
    every value at its dtype's rounding where the step is active (a wrong
    α, β or flag fails), the state bitwise unchanged where it is not."""
    np_dt, dt, _ = DTYPES[dtype]
    k0, limit, share, pAp0 = STEP_CASES[case]
    A = card_dia(317, np_dt, cuda)                  # 100,489 rows: a tail past the vectors
    g = torch.Generator(device=cuda).manual_seed(11)
    x, r, p = (torch.randn(A.shape[0], generator=g, device=cuda, dtype=dt) for _ in range(3))
    Ap, pAp = tsm.spmv_dot(A, p)
    if pAp0 is not None:
        pAp = torch.full((), pAp0, dtype=dt, device=cuda)
    rr = torch.dot(r, r)
    k, maxiter = (torch.tensor(v, dtype=torch.int32, device=cuda) for v in (k0, limit))
    thresh2 = share * rr
    want = torch_step(x, r, p, Ap, pAp, rr, k, maxiter, thresh2)
    state = dict(x=x.clone(), r=r.clone(), p=p.clone(), rr=rr.clone(), k=k.clone())
    krylov.cg_step(state["x"], state["r"], state["p"], Ap, pAp, state["rr"], state["k"],
                   maxiter, thresh2, *krylov.step_scratch(cuda))
    if share > 1 or k0 >= limit:
        for key, v in dict(x=x, r=r, p=p, rr=rr, k=k).items():
            assert torch.equal(state[key], v), key
        return
    assert int(state["k"]) == k0 + 1
    tol = 1e-5 if dt == torch.float32 else 1e-12
    for key in ("x", "r", "p", "rr"):
        err = float((state[key] - want[key]).abs().max() / want[key].abs().max())
        assert err <= tol, (key, err)
