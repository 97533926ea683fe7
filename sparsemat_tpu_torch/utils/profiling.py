"""Kernel timing, and the program's spans and counters (counterpart of
``sparsemat_tpu/utils/profiling.py``).

Times come from the card: CUDA events around many chained launches, after a
warm-up, over a synchronised stream.  A tensor on the CPU is refused, never
timed on the host under a device metric's name.

Spans and counters say what the program was doing.  ``span(name)`` marks a
block of host code: while tracing is on it enters a record function
named ``"sparsemat." + name`` (only while a ``torch.profiler`` records, so
the span lands in its trace as a host op, on the clock of the device's
events) and adds its count, total seconds and self seconds (total less the
time of the spans opened inside it) to an in-memory table.  Tracing is on
while a ``torch.profiler`` records or inside ``with tracing():``.  Off, a
span costs one flag read and returns one shared no-op object: no
allocation, no ``record_function``, no clock read.  Set-up spans
(``setup=True``: a format's freeze, a launch plan, a native build) run once
a matrix and record into the table always.

Counters are dicts of counts, one registry for the program: three groups
of launch counts, which count every launch (``kernels.dia``;
``kernels.plan``, every launch over a row-group plan, in
``kernels/_rowgroup.py``; ``parallel.dist``, the shard products), and the
counts below, which ``count`` adds to only while tracing is on.
``trace_record()`` reads spans and counters; ``reset_trace()`` clears
both.  ``trace_to`` exports a profiler's Chrome trace.

Spans: ``solver.block`` (one block of ``solvers._while``'s steps, or its
graph's replay, or one cycle of ``solvers.gmres``, the host read of the
condition left out), ``ops.spmv`` and ``ops.spmm`` (the
public products), ``freeze.auto_format``, ``freeze.plan`` (a launch plan
built: ``kernels/dia.py`` ``dia_spmv_plan``, ``kernels/_rowgroup.py``
``plan_of``) and ``freeze.build`` (a native library loaded, compiled first
where its build is absent).  Counters: ``solver`` (``steps_executed``,
``steps_committed``, of the loops run as CUDA graphs ``steps_replayed``
and ``graph_captures``, ``steps_fused``, the steps of a body that commits
itself: CG's step kernels, and of GMRES ``cycles``, ``arnoldi_rows``, the
basis rows its committed steps project against, and ``arnoldi_bytes``, their
bytes) and ``ops.conversions`` (the format conversions the
products' dispatch makes at call time, by target format).  The launch
groups count host enqueues: a launch captured into a CUDA graph counts
once, at its capture, and a replay adds none.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence

import torch

from ..types import resolve_device


def _cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"timing needs a CUDA device, got {device}")
    return device


def sync(t: torch.Tensor) -> float:
    """Wait for everything queued on ``t``'s device; returns ``t``'s first
    element."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0]) if t.numel() else 0.0


def dispatch_rtt(device=None) -> float:
    """Seconds of one empty launch on ``device`` (None: the current CUDA
    card), from CUDA events: the least of five launches after a warm-up."""
    device = _cuda(resolve_device(device))
    z = torch.zeros(8, device=device)
    z.add_(1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(5):
        start.record()
        z.add_(1)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def time_chained_op(step_fn: Callable, x0: torch.Tensor, captures: Sequence = (),
                    inner: int = 200, reps: int = 2) -> float:
    """Seconds per application of ``step_fn(v, *captures)``: ``inner``
    chained applications between two CUDA events, the best of ``reps``
    runs after one warm-up run.  ``x0`` must lie on a CUDA card."""
    _cuda(x0.device)

    def run():
        v = x0
        for _ in range(inner):
            v = step_fn(v, *captures)
        return v

    run()
    torch.cuda.synchronize(x0.device)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best / inner


@contextlib.contextmanager
def trace_to(path: str):
    """A ``torch.profiler`` trace of the block (the card's activity where
    torch finds one), written to ``path`` as a Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


# -- spans and counters ------------------------------------------------------------------

_AP = torch.autograd.profiler
if hasattr(_AP, "_is_profiler_enabled"):
    def _profiler_on() -> bool:
        return _AP._is_profiler_enabled
else:
    _profiler_on = torch._C._autograd._profiler_enabled
#: the profiler's host range: PyTorch's C++ record function where it has one
#: (a host op of the trace, about an eighth of ``record_function``'s cost
#: under the profiler), else ``record_function``
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast", _AP.record_function)

#: open ``tracing()`` blocks
_switch = 0
#: name -> [count, total seconds, self seconds]
_SPANS: dict[str, list] = {}
#: the spans open now, innermost last
_OPEN: list = []
#: every counter of the program by name: a dict of counts each
COUNTERS: dict[str, dict] = {}


def on() -> bool:
    """Whether tracing is on: a ``torch.profiler`` records, or a
    ``tracing()`` block is open."""
    return _switch > 0 or _profiler_on()


@contextlib.contextmanager
def tracing():
    """Spans and counters on for the block, with no profiler."""
    global _switch
    _switch += 1
    try:
        yield
    finally:
        _switch -= 1


class _Span:
    __slots__ = ("name", "rf", "t0", "inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiler_on():
            self.rf = _record_function("sparsemat." + self.name)
            self.rf.__enter__()
        self.inner = 0.0
        _OPEN.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        _OPEN.pop()
        if _OPEN:
            _OPEN[-1].inner += dt
        row = _SPANS.get(self.name)
        if row is None:
            row = _SPANS[self.name] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += dt
        row[2] += dt - self.inner
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, setup: bool = False):
    """A context manager that marks a block as span ``name``: recorded
    while tracing is on, or always where ``setup``; otherwise the shared
    no-op."""
    if setup or _switch > 0 or _profiler_on():
        return _Span(name)
    return _OFF


def register(name: str, counts: dict) -> dict:
    """Put ``counts`` (the same dict) into the registry under ``name``;
    returns it."""
    COUNTERS[name] = counts
    return counts


SOLVER = register("solver", {"steps_executed": 0, "steps_committed": 0, "steps_replayed": 0,
                             "steps_fused": 0, "graph_captures": 0, "cycles": 0,
                             "arnoldi_rows": 0, "arnoldi_bytes": 0})
CONVERSIONS = register("ops.conversions", {})


def count(counts: dict, key: str, n: int = 1) -> None:
    """``counts[key] += n`` while tracing is on."""
    if on():
        counts[key] = counts.get(key, 0) + n


def trace_record() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: {key: count}}}``, copies of the table and of every counter."""
    return {"spans": {n: {"count": c, "total_s": t, "self_s": s}
                      for n, (c, t, s) in _SPANS.items()},
            "counters": {n: dict(c) for n, c in COUNTERS.items()}}


def reset_trace() -> None:
    """Empty the span table and set every counter to zero (the kernel
    modules' launch counts included)."""
    _SPANS.clear()
    for counts in COUNTERS.values():
        for key in counts:
            counts[key] = 0
