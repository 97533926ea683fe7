"""Iterative solvers and preconditioners (counterpart of
``sparsemat_tpu/solvers.py``): CG / PCG, BiCGStab, restarted GMRES,
Chebyshev, (weighted) Jacobi, SOR / Gauss–Seidel (``sor``,
``gauss_seidel``), mixed-precision refinement (``refine``,
``refine_host``), the Jacobi and block-Jacobi preconditioners, and the class
wrappers.

The reference compiles each iteration into one ``lax.while_loop``, with no
host round-trip per iteration.  Here ``_while`` runs the loop body in fixed
blocks of ``SYNC_EVERY`` on the device: each step computes a device-side
``active = cond(state)``, commits its update through
``torch.where(active, new, old)``, and the host reads the condition once per
block.  A body may commit itself instead (``_commits_itself``): it computes
``active`` on the device and writes its state in place only where it holds.
Unpreconditioned CG on one CUDA card in f32 or f64 does, through the two
step kernels of ``kernels/krylov.py`` (``_fused_reason`` says where it
does not).  The state freezes once the condition fails and the counters
count only active steps, so the final states and ``iterations`` equal the
reference's.  On a CUDA card, over a format whose product is a launch over a
plan cached on the matrix, a block is captured once into a CUDA graph and
replayed for every later block of every solve on that operator and stream
(``_BlockGraph``): the same kernels in the same order, so the answers are
bitwise the op-by-op loop's.  GMRES keeps the reference's static restart
window (its inner steps freeze instead of exiting) and reads the host once
per cycle.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .formats import DIA
from .kernels import krylov
from .ops.matvec import PLANNED
from .types import is_float_dtype
from .utils import profiling

#: loop steps between two host reads of the loop condition
SYNC_EVERY = 32
#: the block graphs one operator keeps, the least recently used dropped first
GRAPHS_PER_OPERATOR = 4
#: the formats whose CUDA SpMV (``ops/matvec.py``, no ``method``) is one
#: launch over a plan cached on the matrix; the others convert or sort at
#: call time, and their loops run op by op
_GRAPH_FORMATS = (DIA, *(cls for cls, entry in PLANNED.items() if entry.spmv is not None))


class SolveInfo(NamedTuple):
    iterations: torch.Tensor        # iterations actually executed
    residual_norm: torch.Tensor     # final ‖r‖ (recursive residual)
    converged: torch.Tensor         # bool
    residual_history: Optional[torch.Tensor] = None  # (maxiter,) padded with -1


def _as_matvec(A) -> Callable:
    if callable(A) and not hasattr(A, "shape"):
        return A
    if hasattr(A, "shape"):
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"solver requires a square matrix, got {A.shape}")
        from .ops import spmv

        return lambda v: spmv(A, v)
    raise TypeError(f"cannot interpret {type(A)} as a linear operator")


def _check_operands(A, b):
    b = torch.as_tensor(b)
    if not is_float_dtype(b.dtype):
        raise TypeError(
            f"solvers require a float dtype (FloatType gate), got {b.dtype}")
    if hasattr(A, "shape") and b.shape[0] != A.shape[0]:
        raise ValueError(f"dimension mismatch: matrix {A.shape}, rhs {tuple(b.shape)}")
    return b


def _dot(a, b):
    s = torch.sum(a * b)
    # over vectors sharded by rows (DTensors, ``parallel/``) the sum is each
    # rank's partial sum: all-reduce it here, once, so every scalar the loop
    # derives from it is whole, and a plain tensor, on every rank (the JAX
    # package's psum)
    return s.full_tensor() if hasattr(s, "full_tensor") else s


def _as_matvec_dot(A) -> Callable:
    """v → (A·v, v·(A·v)) — CG's hot pair, fused into the DIA SpMV kernel
    through ``ops.spmv_dot``."""
    if callable(A) and not hasattr(A, "shape"):
        def mvd(v):
            y = A(v)
            return y, _dot(v, y)

        return mvd
    from .ops import spmv_dot

    return lambda v: spmv_dot(A, v)


def _precond(M) -> Optional[Callable]:
    return M.apply if hasattr(M, "apply") else M


def _x0(b, x0):
    return (torch.zeros_like(b) if x0 is None
            else torch.as_tensor(x0, dtype=b.dtype, device=b.device))


def _threshold(b, tol, rtol):
    """max(tol, rtol·‖b‖) as a 0-d tensor of b's dtype."""
    return torch.maximum(torch.full((), tol, dtype=b.dtype, device=b.device),
                         rtol * torch.sqrt(_dot(b, b)))


def _commits_itself(body):
    """Mark ``body`` as one that commits its own step, in place and only
    where the loop's condition holds, which it computes on the device:
    ``_block`` then calls it with no ``cond`` and no select."""
    body.commits = True
    return body


def _block(cond, body, state: dict, consts: dict, every: int, on_step=None) -> dict:
    """``every`` steps of the loop, each committed only where ``cond``
    held: by ``torch.where`` on the body's new state, or, for a body that
    commits itself (``_commits_itself``), by the body, under the device's
    active flag (its state is then updated in place and returned)."""
    if getattr(body, "commits", False):
        for _ in range(every):
            body(state, consts)
        return state
    for _ in range(every):
        active = cond(state, consts)
        new = body(state, consts)
        if on_step is not None:
            on_step(active, new)
        state = {k: torch.where(active, new[k], v) for k, v in state.items()}
    return state


def _eager_reason(A, M, state: dict, consts: dict, on_step, every: int) -> Optional[str]:
    """Why the loop over ``A`` runs op by op, or None where its blocks can
    be one CUDA graph: a format of ``_GRAPH_FORMATS`` (not a callable), no
    preconditioner or one of this module's, no ``on_step``, more than one
    step a block, and every tensor of the state, the invariants and the
    preconditioner a plain tensor (no DTensor) on one CUDA card."""
    if on_step is not None:
        return "a callback sees every step"
    if every < 2:
        return "one step a block"
    if not isinstance(A, _GRAPH_FORMATS):
        return "the operator's product is not a launch over a cached plan"
    if M is not None and not isinstance(M, (JacobiPreconditioner, BlockJacobiPreconditioner)):
        return "a preconditioner of another kind"
    tensors = [*state.values(), *consts.values()]
    if M is not None:
        tensors += [getattr(M, f.name) for f in dataclasses.fields(M)
                    if isinstance(getattr(M, f.name), torch.Tensor)]
    if any(type(t) is not torch.Tensor for t in tensors):
        return "a tensor subclass (DTensor)"
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        return "not on one CUDA card"
    return None


class _BlockGraph:
    """One block of a solver loop as a CUDA graph.  The loop's state and
    its invariants live in static buffers that the graph reads; the
    captured block ends by copying its committed state back into the
    state's buffers (a body that commits itself writes them in place, and
    needs no copy), so each replay runs the next block.  Keeps ``M``
    alive: the graph reads its tensors.  Its temporaries live in the
    graph's own memory pool, the launches' scratch included
    (``kernels/dia.py`` ``dot_scratch``, ``kernels/_rowgroup.py``
    ``_scratch``); a scratch among the invariants (``kernels/krylov.py``
    ``step_scratch``) is one of the static buffers."""

    def __init__(self, state: dict, consts: dict, M):
        self.state = {k: v.clone() for k, v in state.items()}
        self.consts = {k: v.clone() for k, v in consts.items()}
        self.M = M
        self.device = next(iter(self.state.values())).device
        self.graph = None

    def capture(self, cond, body, every: int) -> None:
        # a side stream of the state's card (the default stream cannot capture)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(
                self.graph, stream=torch.cuda.Stream(self.device)):
            out = _block(cond, body, self.state, self.consts, every)
            for k, v in out.items():
                if v is not self.state[k]:
                    self.state[k].copy_(v)

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()

    def load(self, state: dict, consts: dict) -> None:
        for bufs, vals in ((self.state, state), (self.consts, consts)):
            for k, v in vals.items():
                bufs[k].copy_(v)


def _signature(tensors: dict) -> tuple:
    return tuple((k, v.dtype, tuple(v.shape)) for k, v in tensors.items())


def _graph_key(body, M, state: dict, consts: dict, every: int) -> tuple:
    """The key of a loop's block graph on its operator: the body's code,
    ``every``, the preconditioner object, the tensors' dtypes and shapes,
    and the stream the solve enqueues on (solves on two streams at once
    share no buffers)."""
    dev = next(iter(state.values())).device
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
    return body.__code__, every, id(M), stream, _signature(state), _signature(consts)


def _while(cond, body, state: dict, consts: dict, maxiter: int, *, A=None, M=None,
           on_step=None, every: int = SYNC_EVERY) -> dict:
    """``lax.while_loop(cond, body, state)`` on the device for a loop whose
    condition includes ``k < maxiter``: steps run in blocks of ``every``,
    each committed only where ``cond(state, consts)`` held, and the host
    reads ``cond`` once per block.  ``consts`` holds the loop's tensor
    invariants (thresholds, right-hand sides, a solver's numbers, ``maxiter``
    as a 0-d int32, and a body's scratch that every step leaves as it found
    it, such as CG's step kernels' counter); ``cond`` and ``body`` read them
    from there and close over no tensor or number of the solve.  ``on_step(active, new)`` sees
    every step (for histories).

    Where ``_eager_reason`` finds none, the blocks are one CUDA graph kept
    on ``A`` under ``_graph_key``: a new key runs its first block op by op
    (so every lazy plan and scratch is made outside the capture), then
    captures the next and replays it; a known key loads the solve's state
    and invariants into the graph's buffers and replays every block.  What
    it returns are copies.

    While tracing is on (``utils.profiling``), each block's enqueue (or
    replay) is the span ``solver.block`` and the ``solver`` counters take
    the steps executed, the steps replayed, the steps of a body that
    commits itself (``steps_fused``), the captures and, from a state's
    ``k``, the steps committed."""
    graphs = key = loop = None
    if _eager_reason(A, M, state, consts, on_step, every) is None:
        graphs = A.__dict__.get("_solver_graphs")
        if graphs is None:
            graphs = collections.OrderedDict()
            object.__setattr__(A, "_solver_graphs", graphs)
        key = _graph_key(body, M, state, consts, every)
        loop = graphs.get(key)
        if loop is not None:
            graphs.move_to_end(key)
            loop.load(state, consts)
    for _ in range(-(-max(int(maxiter), 0) // every)):
        with profiling.span("solver.block"):
            if loop is None:
                state = _block(cond, body, state, consts, every, on_step)
            else:
                loop.replay()
        profiling.count(profiling.SOLVER, "steps_executed", every)
        if getattr(body, "commits", False):
            profiling.count(profiling.SOLVER, "steps_fused", every)
        if loop is not None:
            profiling.count(profiling.SOLVER, "steps_replayed", every)
        now = (state, consts) if loop is None else (loop.state, loop.consts)
        if not bool(cond(*now)):
            break
        if graphs is not None and loop is None:
            loop = _BlockGraph(state, consts, M)
            loop.capture(cond, body, every)
            graphs[key] = loop
            profiling.count(profiling.SOLVER, "graph_captures")
            while len(graphs) > GRAPHS_PER_OPERATOR:
                graphs.popitem(last=False)
    if loop is not None:
        state = {k: v.clone() for k, v in loop.state.items()}
    if "k" in state and profiling.on():
        # the loop's last host read has already waited for k
        profiling.count(profiling.SOLVER, "steps_committed", int(state["k"]))
    return state


def _int32(v, device):
    return torch.tensor(v, dtype=torch.int32, device=device)


def _number(v: float, b):
    """A solver's number as a 0-d tensor of ``b``'s dtype and device."""
    return torch.tensor(v, dtype=b.dtype, device=b.device)


def _limit(maxiter, device):
    """``maxiter`` as the loop's 0-d int32 invariant (k never passes
    2³¹ − 1, so a larger limit reads as that)."""
    return _int32(min(math.ceil(maxiter), 2**31 - 1), device)


# --- Conjugate Gradient ------------------------------------------------------

def _fused_reason(b, x, r, M, record_history: bool) -> Optional[str]:
    """Why ``cg`` runs its body of PyTorch ops and selects, or None where it
    runs the step kernels of ``kernels/krylov.py``, which commit themselves:
    no preconditioner (z = r), no history, and b, x and r plain tensors (no
    DTensor) of one dtype the kernels take (f32, f64) on one CUDA card."""
    if M is not None:
        return "a preconditioner"
    if record_history:
        return "a callback sees every step"
    vectors = (b, x, r)
    if any(type(t) is not torch.Tensor for t in vectors):
        return "a tensor subclass (DTensor)"
    if any(t.dtype != r.dtype for t in vectors) or r.dtype not in krylov.DTYPES:
        return "not one dtype of float32 or float64"
    if r.device.type != "cuda" or any(t.device != r.device for t in vectors):
        return "not on one CUDA card"
    return None


def cg(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
       maxiter: int = 10_000, M=None, record_history: bool = False):
    """Conjugate Gradient.  Convergence: ‖r‖ < max(tol, rtol·‖b‖).  ``M``:
    optional preconditioner (callable z = M(r), or an object with
    ``apply``) → standard PCG.  ``A`` is a square sparse format or a
    matvec callable."""
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    matvec_dot = _as_matvec_dot(A)
    precond = _precond(M)
    threshold = _threshold(b, tol, rtol)

    x = _x0(b, x0)
    r = b - matvec(x)
    consts = dict(maxiter=_limit(maxiter, b.device), thresh2=threshold * threshold)

    def cond(s, c):
        return (s["k"] < c["maxiter"]) & (s["rr"] >= c["thresh2"])

    if _fused_reason(b, x, r, M, record_history) is None:
        # the step kernels update x, r and p in place: x may be the
        # caller's x0, and p starts as r (z = r, so rr is also r·z)
        state = dict(x=x.clone(), r=r, p=r.clone(), rr=_dot(r, r), k=_int32(0, b.device))
        # the kernels' scratch, one pair a solve (a block graph keeps its own)
        consts["work"], consts["counter"] = krylov.step_scratch(b.device)

        @_commits_itself
        def body(s, c):
            Ap, pAp = matvec_dot(s["p"])
            krylov.cg_step(s["x"], s["r"], s["p"], Ap, pAp, s["rr"], s["k"], c["maxiter"],
                           c["thresh2"], c["work"], c["counter"])
            return s
    else:
        z = precond(r) if precond is not None else r
        state = dict(x=x, r=r, p=z, rz=_dot(r, z), rr=_dot(r, r),
                     k=_int32(0, b.device))

        def body(s, c):
            Ap, pAp = matvec_dot(s["p"])
            # guarded divisions: a breakdown (pAp = 0) stalls instead of
            # poisoning the state with NaN
            alpha = torch.where(pAp != 0, s["rz"] / pAp, 0)
            x = s["x"] + alpha * s["p"]
            r = s["r"] - alpha * Ap
            z = precond(r) if precond is not None else r
            rz = _dot(r, z)
            beta = torch.where(s["rz"] != 0, rz / s["rz"], 0)
            return dict(x=x, r=r, p=z + beta * s["p"], rz=rz, rr=_dot(r, r),
                        k=s["k"] + 1)

    hist = []
    on_step = None
    if record_history:
        def on_step(active, new):
            hist.append(torch.where(active, torch.sqrt(new["rr"]), -1.0))

    out = _while(cond, body, state, consts, maxiter, A=A, M=M, on_step=on_step)
    history = None
    if record_history:
        history = torch.full((maxiter,), -1.0, dtype=b.dtype, device=b.device)
        if hist:
            h = torch.stack(hist)[:maxiter]
            history[:h.shape[0]] = h
    res = torch.sqrt(out["rr"])
    return out["x"], SolveInfo(iterations=out["k"], residual_norm=res,
                               converged=res < threshold, residual_history=history)


# --- BiCGStab (nonsymmetric systems) ----------------------------------------

def bicgstab(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
             maxiter: int = 10_000, M=None):
    """Biconjugate gradient stabilized, optionally right-preconditioned."""
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    precond = _precond(M) or (lambda v: v)
    threshold = _threshold(b, tol, rtol)

    x = _x0(b, x0)
    r0 = b - matvec(x)
    rhat = r0
    one = torch.ones((), dtype=b.dtype, device=b.device)
    state = dict(x=x, r=r0, p=r0, v=torch.zeros_like(b), rho=_dot(rhat, r0),
                 alpha=one, omega=one, k=_int32(0, b.device), rr=_dot(r0, r0))
    consts = dict(maxiter=_limit(maxiter, b.device), threshold=threshold, rhat=rhat)

    def cond(s, c):
        return (s["k"] < c["maxiter"]) & (torch.sqrt(s["rr"]) >= c["threshold"])

    def body(s, c):
        phat = precond(s["p"])
        v = matvec(phat)
        rv = _dot(c["rhat"], v)
        alpha = torch.where(rv != 0, s["rho"] / rv, 0)
        h = s["x"] + alpha * phat
        sres = s["r"] - alpha * v
        shat = precond(sres)
        t = matvec(shat)
        tt = _dot(t, t)
        omega = torch.where(tt > 0, _dot(t, sres) / tt, 0.0)
        x = h + omega * shat
        r = sres - omega * t
        rho = _dot(c["rhat"], r)
        beta = torch.where((s["rho"] != 0) & (omega != 0),
                           (rho / s["rho"]) * (alpha / omega), 0)
        p = r + beta * (s["p"] - omega * v)
        return dict(x=x, r=r, p=p, v=v, rho=rho, alpha=alpha, omega=omega,
                    k=s["k"] + 1, rr=_dot(r, r))

    out = _while(cond, body, state, consts, maxiter, A=A, M=M)
    res = torch.sqrt(out["rr"])
    return out["x"], SolveInfo(iterations=out["k"], residual_norm=res,
                               converged=res < threshold)


# --- GMRES(restart) ----------------------------------------------------------

def gmres(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
          restart: int = 30, maxiter: int = 10_000, M=None):
    """Restarted GMRES over a static restart window: the Krylov basis V is
    (restart+1, n), Givens rotations keep the Hessenberg matrix's QR so the
    residual is known every step, and a converged cycle's remaining steps
    freeze (identity columns) instead of exiting.  ``maxiter`` counts inner
    steps; ``iterations`` counts whole cycles × restart, as the reference
    does.  One host read per cycle.

    While tracing is on (``utils.profiling``), each cycle's enqueue is the
    span ``solver.block`` (its host read of the residual left out) and the
    ``solver`` counters take ``restart`` steps executed and one cycle a
    cycle, and, from the cycle's active-step count read with its residual,
    the steps committed and ``arnoldi_rows``, the basis rows that the
    committed steps' Gram–Schmidt projects against (j + 1 at step j), with
    ``arnoldi_bytes``, those rows' bytes."""
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    precond = _precond(M) or (lambda v: v)
    m = int(restart)
    dt, dev = b.dtype, b.device
    threshold = _threshold(b, tol, rtol)
    n_cycles = max(-(-int(maxiter) // m), 1)
    steps_idx = torch.arange(m + 1, device=dev)
    solve_dt = torch.promote_types(dt, torch.float32)

    def cycle(x):
        r = b - matvec(x)
        beta = torch.sqrt(_dot(r, r))
        V = torch.zeros((m + 1, b.shape[0]), dtype=dt, device=dev)
        V[0] = torch.where(beta > 0, r / torch.where(beta > 0, beta, 1), 0)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        g = torch.zeros(m + 1, dtype=dt, device=dev)
        g[0] = beta
        # rot[i] = [[c_i, s_i], [-s_i, c_i]], the i-th Givens rotation
        rot = torch.eye(2, dtype=dt, device=dev).repeat(m, 1, 1)
        active = beta >= threshold
        steps = _int32(0, dev)
        for j in range(m):
            # a bf16 or f16 product accumulates into f32: back to the basis's
            # dtype (for f32 and f64 a no-op)
            w = matvec(precond(V[j])).to(dt)
            # classical Gram-Schmidt: w projected against every basis row at
            # once (rows past j are zero, and h is masked past j)
            h = torch.where(steps_idx <= j, V @ w, 0)
            w = w - V.T @ h
            h_next = torch.sqrt(_dot(w, w))
            v_next = torch.where(h_next > 0, w / torch.where(h_next > 0, h_next, 1), 0)
            hcol = h.clone()
            hcol[j + 1] = h_next
            for i in range(j):       # the previous rotations, in order
                hcol[i:i + 2] = rot[i] @ hcol[i:i + 2]
            hj, hj1 = hcol[j].clone(), hcol[j + 1].clone()
            denom = torch.sqrt(hj ** 2 + hj1 ** 2)
            safe = torch.where(denom > 0, denom, 1)
            c_j = torch.where(denom > 0, hj / safe, 1.0)
            s_j = torch.where(denom > 0, hj1 / safe, 0.0)
            hcol[j] = c_j * hj + s_j * hj1
            hcol[j + 1] = 0.0
            g_new = g.clone()
            g_new[j] = c_j * g[j]
            g_new[j + 1] = -s_j * g[j]
            still = active & (torch.abs(g_new[j + 1]) >= threshold) & (h_next > 0)
            # a frozen step gets an identity column, so back-substitution
            # yields 0 for it
            eye_col = (steps_idx == j).to(dt)
            V[j + 1] = torch.where(active, v_next, 0)
            H[:, j] = torch.where(active, hcol, eye_col)
            c_j = torch.where(active, c_j, 1.0)
            s_j = torch.where(active, s_j, 0.0)
            rot[j] = torch.stack([torch.stack([c_j, s_j]), torch.stack([-s_j, c_j])])
            g = torch.where(active, g_new, g)
            steps = steps + active.to(torch.int32)
            active = still
        # g past the active steps is masked: the first frozen slot carries
        # the final residual, which must not leak into the correction
        g_solve = torch.where(steps_idx[:m] < steps, g[:m], 0)
        # the triangular solve has no half-precision kernel: bf16 and f16
        # solve it in f32 (for f32 and f64 the casts are no-ops)
        y = torch.linalg.solve_triangular(H[:m, :m].to(solve_dt), g_solve[:, None].to(solve_dt),
                                          upper=True)[:, 0].to(dt)
        x = x + precond(V[:m].T @ y)
        r2 = b - matvec(x)
        return x, torch.sqrt(_dot(r2, r2)), steps

    x = _x0(b, x0)
    r0 = b - matvec(x)
    res = torch.sqrt(_dot(r0, r0))
    k, steps = 0, None
    while True:
        if steps is not None and profiling.on():
            # while tracing, the cycle's active steps ride on its residual's
            # host read (off, the loop reads the residual alone)
            done, n_active = torch.stack([(res < threshold).to(torch.int32), steps]).tolist()
            rows = n_active * (n_active + 1) // 2
            profiling.count(profiling.SOLVER, "steps_committed", n_active)
            profiling.count(profiling.SOLVER, "arnoldi_rows", rows)
            profiling.count(profiling.SOLVER, "arnoldi_bytes", rows * b.shape[0] * b.element_size())
            if done or k >= n_cycles * m:
                break
        elif k >= n_cycles * m or bool(res < threshold):
            break
        with profiling.span("solver.block"):
            x, res, steps = cycle(x)
        k += m
        profiling.count(profiling.SOLVER, "steps_executed", m)
        profiling.count(profiling.SOLVER, "cycles")
    return x, SolveInfo(iterations=_int32(k, dev), residual_norm=res,
                        converged=res < threshold)


# --- Chebyshev ----------------------------------------------------------------

def chebyshev(A, b, x0=None, *, lambda_min: float, lambda_max: float,
              tol: float = 1e-12, rtol: float = 0.0, maxiter: int = 10_000):
    """Chebyshev semi-iteration for SPD systems with known spectral bounds
    [lambda_min, lambda_max].  No inner products in the update."""
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    theta = (lambda_max + lambda_min) / 2.0
    delta = (lambda_max - lambda_min) / 2.0
    sigma1 = theta / delta
    threshold = _threshold(b, tol, rtol)

    state = dict(x=_x0(b, x0), d=torch.zeros_like(b),
                 rho=_number(sigma1, b), k=_int32(0, b.device),
                 rr=torch.tensor(float("inf"), dtype=b.dtype, device=b.device))
    consts = dict(maxiter=_limit(maxiter, b.device), thresh2=threshold * threshold, b=b,
                  theta=_number(theta, b), delta=_number(delta, b), sigma1=_number(sigma1, b))

    def cond(s, c):
        return (s["k"] < c["maxiter"]) & (s["rr"] >= c["thresh2"])

    def body(s, c):
        r = c["b"] - matvec(s["x"])
        first = s["k"] == 0
        rho = torch.where(first, 1.0 / c["sigma1"], 1.0 / (2.0 * c["sigma1"] - s["rho"]))
        d = torch.where(first, r / c["theta"],
                        rho * s["rho"] * s["d"] + (2.0 * rho / c["delta"]) * r)
        return dict(x=s["x"] + d, d=d, rho=rho, k=s["k"] + 1, rr=_dot(r, r))

    out = _while(cond, body, state, consts, maxiter, A=A)
    res = torch.sqrt(out["rr"])
    return out["x"], SolveInfo(iterations=out["k"], residual_norm=res,
                               converged=res < threshold)


# --- Jacobi ------------------------------------------------------------------

def jacobi(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
           maxiter: int = 10_000, omega: float = 1.0):
    """(Weighted) Jacobi iteration: x ← x + ω D⁻¹ (b − A x)."""
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    if not hasattr(A, "to_csr"):
        raise TypeError("jacobi needs a sparse format (for its diagonal)")
    d = A.to_csr().diagonal().to(b.dtype)
    threshold = _threshold(b, tol, rtol)

    state = dict(x=_x0(b, x0), k=_int32(0, b.device),
                 rr=torch.tensor(float("inf"), dtype=b.dtype, device=b.device))
    consts = dict(maxiter=_limit(maxiter, b.device), thresh2=threshold * threshold, b=b,
                  wdinv=omega * torch.where(d != 0, 1.0 / d, 0.0))

    def cond(s, c):
        return (s["k"] < c["maxiter"]) & (s["rr"] >= c["thresh2"])

    def body(s, c):
        r = c["b"] - matvec(s["x"])
        # ω·D⁻¹ is one invariant: ω · D⁻¹ · r multiplies ω · D⁻¹ first
        return dict(x=s["x"] + c["wdinv"] * r, k=s["k"] + 1, rr=_dot(r, r))

    out = _while(cond, body, state, consts, maxiter, A=A)
    res = torch.sqrt(out["rr"])
    return out["x"], SolveInfo(iterations=out["k"], residual_norm=res,
                               converged=res < threshold)


# --- Gauss-Seidel / SOR ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SorSchedule:
    """A matrix's rows in levels for the SOR sweep.  Every row that row i
    reads new (a stored a_ij, j < i) lies in an earlier level than i, so
    the rows of one level update at once.  ``perm`` lists the rows level
    by level (ascending within a level); level l is ``perm[row_ptr[l]:
    row_ptr[l + 1]]``.  Its rows' CSR entries, row by row, are
    ``[entry_ptr[l], entry_ptr[l + 1])`` of ``entries`` (positions in the
    CSR), ``src`` and ``diag_slot``; ``seg_ptr[row_ptr[l] + l :
    row_ptr[l + 1] + l + 1]`` are the level's row offsets into them, from
    0.  ``src`` indexes a buffer of 2n: the new x where the column is below
    the row, n + the column (the old x) elsewhere; ``diag_slot`` marks the
    diagonal entries."""

    perm: torch.Tensor
    entries: torch.Tensor
    src: torch.Tensor
    diag_slot: torch.Tensor
    seg_ptr: torch.Tensor
    row_ptr: tuple
    entry_ptr: tuple

    @property
    def n_levels(self) -> int:
        return len(self.row_ptr) - 1


def _ranges(starts, counts):
    """Concatenated [s, s + c) for each pair (host int64 arrays)."""
    total = int(counts.sum())
    off = np.repeat(starts - np.cumsum(counts) + counts, counts)
    return off + np.arange(total, dtype=np.int64)


def sor_levels(indptr, indices) -> list:
    """Rows in dependency levels over the strictly lower triangle of a CSR
    (host arrays): level 0 holds the rows with no entry left of the
    diagonal, level l + 1 the rows whose last such dependency is in level
    l (each level ascending)."""
    ip = np.asarray(indptr, np.int64)
    n = ip.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ip))
    cols = np.asarray(indices[: ip[-1]], np.int64)
    low = cols < rows
    waiter, dep = rows[low], cols[low]
    indeg = np.bincount(waiter, minlength=n)
    waiters = waiter[np.argsort(dep, kind="stable")]
    wptr = np.concatenate([[0], np.cumsum(np.bincount(dep, minlength=n))])
    levels = []
    frontier = np.flatnonzero(indeg == 0)
    while frontier.size:
        levels.append(frontier)
        released = waiters[_ranges(wptr[frontier], wptr[frontier + 1] - wptr[frontier])]
        rel, cnt = np.unique(released, return_counts=True)
        indeg[rel] -= cnt
        frontier = rel[indeg[rel] == 0]
    return levels


def sor_schedule(csr) -> SorSchedule:
    """The level schedule of a CSR, built on the host once and cached on
    it (a frozen matrix never changes)."""
    sched = csr.__dict__.get("_sor_schedule")
    if sched is not None:
        return sched
    ip = csr.host("indptr").astype(np.int64)
    indices = csr.host("indices")
    n = csr.n_rows
    levels = sor_levels(ip, indices)
    perm = np.concatenate(levels) if levels else np.zeros(0, np.int64)
    lengths = ip[perm + 1] - ip[perm]
    entries = _ranges(ip[perm], lengths)
    cols = indices[entries].astype(np.int64)
    rows = np.repeat(perm, lengths)
    row_ptr = np.concatenate([[0], np.cumsum([lv.size for lv in levels])]).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(lengths)])
    seg_ptr = np.concatenate([cum[r0:r1 + 1] - cum[r0]
                              for r0, r1 in zip(row_ptr[:-1], row_ptr[1:])] or [np.zeros(0)])
    dev = csr.device
    sched = SorSchedule(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            perm, entries, np.where(cols < rows, cols, n + cols), cols == rows,
            seg_ptr.astype(np.int64))),
        row_ptr=tuple(row_ptr.tolist()), entry_ptr=tuple(cum[row_ptr].tolist()))
    object.__setattr__(csr, "_sor_schedule", sched)
    return sched


def sor(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
        maxiter: int = 1_000, omega: float = 1.0):
    """Successive over-relaxation (ω = 1: Gauss–Seidel).  A sweep updates
    rows 0…n−1 in order: row i reads the new x_j for j < i and the old x_j
    elsewhere, x_i ← (1−ω)·x_i + ω·(b_i − Σ_{j≠i} a_ij·x_j)/a_ii (0 where
    a_ii is 0).  Here a sweep walks the matrix's level schedule
    (``sor_schedule``): each level is one gather of x over its rows' CSR
    entries, a product and a segment sum per row, and one update of its
    rows (five to seven launches a level).  The gather reads a buffer
    holding the sweep's new x and its old x side by side, so a row j > i
    that falls in an earlier level than i (a_ji = 0) still reaches row i
    old.  The iterate is the row-by-row sweep's up to summation order.
    After each sweep the residual ‖b − A·x‖ is checked against
    max(tol, rtol·‖b‖)."""
    b = _check_operands(A, b)
    if not hasattr(A, "to_csr"):
        raise TypeError("sor needs a sparse format")
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"sor requires a square matrix, got {A.shape}")
    from .ops import spmv

    csr = A.to_csr()
    sched = sor_schedule(csr)
    n = A.shape[0]
    diag = csr.diagonal().to(b.dtype)
    dinv = torch.where(diag != 0, 1.0 / diag, 0.0)
    # everything a level reads, in level order, sliced once per solve: the
    # off-diagonal values (the diagonal's slot holds 0), ω/a_ii, ω·b_i/a_ii
    # and the old x_i's place in the buffer
    rows = sched.perm
    vals = csr.data[sched.entries].to(b.dtype).masked_fill(sched.diag_slot, 0)
    wdinv = omega * dinv[rows]
    wdb = wdinv * b[rows]
    old = rows + n
    levels = [(rows[r0:r1], old[r0:r1], sched.src[e0:e1], vals[e0:e1],
               sched.seg_ptr[r0 + k:r1 + k + 1], wdinv[r0:r1], wdb[r0:r1])
              for k, (r0, r1, e0, e1) in enumerate(zip(sched.row_ptr[:-1], sched.row_ptr[1:],
                                                       sched.entry_ptr[:-1],
                                                       sched.entry_ptr[1:]))]

    def sweep(x):
        X = torch.cat([x, x])           # [new | old]
        for rows_l, old_l, src_l, vals_l, seg_l, wdinv_l, wdb_l in levels:
            s = torch.segment_reduce(vals_l * X[src_l], "sum", offsets=seg_l, unsafe=True)
            # x_i ← (1−ω)·x_i + ω·(b_i − s_i)/a_ii, s_i = Σ_{j≠i} a_ij·x_j
            base = wdb_l if omega == 1 else torch.add(wdb_l, X[old_l], alpha=1 - omega)
            X.index_copy_(0, rows_l, torch.addcmul(base, wdinv_l, s, value=-1))
        return X[:n]

    threshold = _threshold(b, tol, rtol)
    state = dict(x=_x0(b, x0), k=_int32(0, b.device),
                 rr=torch.tensor(float("inf"), dtype=b.dtype, device=b.device))
    consts = dict(maxiter=_limit(maxiter, b.device), thresh2=threshold * threshold)

    def cond(s, c):
        return (s["k"] < c["maxiter"]) & (s["rr"] >= c["thresh2"])

    def body(s, c):
        x = sweep(s["x"])
        r = b - spmv(A, x)
        return dict(x=x, k=s["k"] + 1, rr=_dot(r, r))

    # a sweep is many launches, so the host reads the condition after each
    # (and the loop runs op by op)
    out = _while(cond, body, state, consts, maxiter, every=1)
    res = torch.sqrt(out["rr"])
    return out["x"], SolveInfo(iterations=out["k"], residual_norm=res,
                               converged=res < threshold)


def gauss_seidel(A, b, x0=None, **kw):
    return sor(A, b, x0, omega=1.0, **kw)


# --- mixed-precision iterative refinement ------------------------------------

def _refine_outer(residual, correct, threshold: float, max_outer: int):
    """The outer loop of both refinements: ``residual()`` → (r, ‖r‖ as a
    float) in high precision; ``correct(r, ‖r‖)`` solves the scaled
    correction system, updates x and returns its inner iterations.  Stops
    at the threshold, or after two outer steps in a row that do not halve
    ‖r‖.  Returns (per-outer ‖r‖ history, total inner iterations)."""
    hist = []
    total_inner = 0
    prev_norm = np.inf
    stalled = 0
    for _ in range(max_outer):
        r, rnorm = residual()
        hist.append(rnorm)
        if rnorm <= threshold:
            break
        if rnorm >= 0.5 * prev_norm:
            stalled += 1
            if stalled >= 2:                    # refinement no longer gaining
                break
        else:
            stalled = 0
        prev_norm = rnorm
        total_inner += correct(r, rnorm)
    return hist, total_inner


def refine(A, b, x0=None, *, tol: float = 1e-8, rtol: float = 0.0,
           max_outer: int = 40, inner=cg, inner_rtol: float = 1e-2,
           inner_maxiter: int = 4000, low_dtype=torch.float32,
           A_low=None, M=None):
    """Mixed-precision iterative refinement: high-precision (b's dtype,
    typically f64) residuals steer low-precision inner solves of A d = r,
    each to a relative reduction ``inner_rtol`` on the system scaled to
    ‖r‖ = 1.  ``A_low`` defaults to ``A.astype(low_dtype)``.  Returns
    (x, SolveInfo) with ``iterations`` counting all inner iterations and
    ``residual_history`` the ‖r‖ of each outer step."""
    b = _check_operands(A, b)
    hi, dev = b.dtype, b.device
    matvec = _as_matvec(A)
    if A_low is None:
        A_low = A.astype(low_dtype) if hasattr(A, "astype") else A
    x = _x0(b, x0)
    threshold = float(max(tol, rtol * float(torch.linalg.norm(b))))

    def residual():
        r = b - matvec(x)                       # one high-precision SpMV
        return r, float(torch.linalg.norm(r))   # one host read per outer step

    def correct(r, rnorm):
        nonlocal x
        d, info = inner(A_low, (r / rnorm).to(low_dtype), tol=0.0,
                        rtol=inner_rtol, maxiter=inner_maxiter, M=M)
        x = x + d.to(hi) * rnorm
        return int(info.iterations)

    hist, total_inner = _refine_outer(residual, correct, threshold, max_outer)
    rnorm = float(torch.linalg.norm(b - matvec(x)))
    return x, SolveInfo(
        iterations=_int32(total_inner, dev),
        residual_norm=torch.tensor(rnorm, dtype=hi, device=dev),
        converged=torch.tensor(rnorm <= threshold, device=dev),
        residual_history=torch.tensor(hist, dtype=hi, device=dev))


def refine_host(A_high, b, x0=None, *, tol: float = 1e-8, rtol: float = 0.0,
                max_outer: int = 40, inner=cg, A_low=None,
                inner_rtol: float = 1e-2, inner_maxiter: int = 4000,
                low_dtype=torch.float32, M=None):
    """Iterative refinement with the high-precision half on the host: the
    outer residual r = b − A x is a host numpy/scipy float64 SpMV
    (``A_high``: scipy sparse matrix, numpy array or callable), the inner
    solves run in ``low_dtype`` on the device operator ``A_low``
    (required).  Returns (x as float64 numpy, SolveInfo); the info's norms
    are float32, as the reference's are."""
    if A_low is None:
        raise ValueError("refine_host needs A_low, the low-precision device operator")
    matvec = A_high if (callable(A_high) and not hasattr(A_high, "shape")) \
        else (lambda v: A_high @ v)
    b = np.asarray(b, np.float64)
    x = np.zeros_like(b) if x0 is None else np.asarray(x0, np.float64).copy()
    threshold = float(max(tol, rtol * np.linalg.norm(b)))

    def residual():
        r = b - matvec(x)                       # host f64 SpMV
        return r, float(np.linalg.norm(r))

    def correct(r, rnorm):
        nonlocal x
        r_low = torch.from_numpy(r / rnorm).to(device=A_low.device, dtype=low_dtype)
        d, info = inner(A_low, r_low, tol=0.0, rtol=inner_rtol,
                        maxiter=inner_maxiter, M=M)
        x = x + d.double().cpu().numpy() * rnorm
        return int(info.iterations)

    hist, total_inner = _refine_outer(residual, correct, threshold, max_outer)
    rnorm = float(np.linalg.norm(b - matvec(x)))
    return x, SolveInfo(
        iterations=torch.tensor(total_inner, dtype=torch.int32),
        residual_norm=torch.tensor(rnorm, dtype=torch.float32),
        converged=torch.tensor(rnorm <= threshold),
        residual_history=torch.tensor(hist, dtype=torch.float32))


# --- preconditioners ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JacobiPreconditioner:
    """M⁻¹ = D⁻¹."""

    dinv: torch.Tensor

    @classmethod
    def from_matrix(cls, A) -> "JacobiPreconditioner":
        d = A.to_csr().diagonal()
        return cls(dinv=torch.where(d != 0, 1.0 / d, 0.0))

    def apply(self, r):
        return self.dinv.to(r.dtype) * r


@dataclasses.dataclass(frozen=True)
class BlockJacobiPreconditioner:
    """M⁻¹ = blockdiag(A₀₀⁻¹, A₁₁⁻¹, …) over contiguous ``block_size``-row
    blocks: the block diagonal is densified once, inverted with one batched
    ``torch.linalg.inv``, and applied as one batched product.  Structurally
    empty diagonal slots (and the padded tail of the last block) get a unit
    pivot so every block is invertible."""

    blocks_inv: torch.Tensor  # (n_blocks, bs, bs)
    n: int

    @classmethod
    def from_matrix(cls, A, block_size: int = 64) -> "BlockJacobiPreconditioner":
        coo = A.to_csr().to_coo()
        n = A.shape[0]
        bs = block_size
        nb = -(-n // bs)
        r = coo.rows.long()
        c = coo.cols.long()
        keep = (r // bs == c // bs) & (r < n)
        r, c = r[keep], c[keep]
        blocks = torch.zeros((nb, bs, bs), dtype=coo.vals.dtype, device=coo.vals.device)
        # canonical CSR entries are unique, so the scatter needs no order
        blocks.index_put_((r // bs, r % bs, c % bs), coo.vals[keep], accumulate=True)
        diag = torch.diagonal(blocks, dim1=1, dim2=2)
        fix = (diag == 0).to(blocks.dtype)
        blocks = blocks + fix[:, :, None] * torch.eye(bs, dtype=blocks.dtype,
                                                      device=blocks.device)
        return cls(blocks_inv=torch.linalg.inv(blocks), n=n)

    def apply(self, r):
        nb, bs, _ = self.blocks_inv.shape
        rp = F.pad(r, (0, nb * bs - self.n)).reshape(nb, bs, 1)
        z = torch.bmm(self.blocks_inv.to(r.dtype), rp)
        return z.reshape(-1)[: self.n]


# --- class-style API ---------------------------------------------------------

@dataclasses.dataclass
class ConjugateGradient:
    """Object-style wrapper with the reference's defaults (tol=1e-12,
    iter_max=10000)."""

    tol: float = 1e-12
    iter_max: int = 10_000

    def solve(self, mat, b, x=None):
        """Returns (x, info)."""
        return cg(mat, b, x0=x, tol=self.tol, maxiter=self.iter_max)


@dataclasses.dataclass
class Jacobi:
    tol: float = 1e-12
    iter_max: int = 10_000
    omega: float = 1.0

    def solve(self, mat, b, x=None):
        return jacobi(mat, b, x0=x, tol=self.tol, maxiter=self.iter_max,
                      omega=self.omega)


@dataclasses.dataclass
class BiCGStab:
    tol: float = 1e-12
    iter_max: int = 10_000

    def solve(self, mat, b, x=None):
        return bicgstab(mat, b, x0=x, tol=self.tol, maxiter=self.iter_max)


@dataclasses.dataclass
class GMRES:
    tol: float = 1e-12
    iter_max: int = 10_000
    restart: int = 30

    def solve(self, mat, b, x=None):
        return gmres(mat, b, x0=x, tol=self.tol, maxiter=self.iter_max,
                     restart=self.restart)
