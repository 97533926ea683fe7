"""Kernel timing and roofline accounting (counterpart of
``sparsemat_tpu/utils/profiling.py``).

Times come from the card: CUDA events around many chained launches, after a
warm-up, over a synchronised stream.  A tensor on the CPU is refused, never
timed on the host under a device metric's name.  The memory rate of a
roofline is the caller's argument: the port assumes no card's rate.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


@dataclasses.dataclass
class KernelReport:
    """Roofline report for one kernel invocation profile."""

    name: str
    seconds: float
    nnz: int
    bytes_model: int
    flops: int
    hbm_bw: float  # bytes/s the memory can stream (the caller's figure)

    @property
    def gnnz_per_s(self) -> float:
        return self.nnz / self.seconds / 1e9

    @property
    def gb_per_s(self) -> float:
        return self.bytes_model / self.seconds / 1e9

    @property
    def roofline_seconds(self) -> float:
        return self.bytes_model / self.hbm_bw

    @property
    def roofline_fraction(self) -> float:
        return self.roofline_seconds / self.seconds

    def __str__(self):
        return (f"{self.name}: {self.seconds*1e6:.1f} us  "
                f"{self.gnnz_per_s:.2f} Gnnz/s  {self.gb_per_s:.0f} GB/s  "
                f"{100*self.roofline_fraction:.1f}% of roofline")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def spmv_bytes_model(fmt) -> int:
    """The JAX package's minimal traffic model for one SpMV on a frozen
    format: the layout's value and index arrays (DIA, ELL, WELL) or 8 bytes
    an entry (every other format), and 4 bytes a row and a column."""
    n_rows, n_cols = fmt.shape
    name = type(fmt).__name__
    vec = 4 * (n_rows + n_cols)
    if name == "DIA":
        return _nbytes(fmt.data) + vec
    if name == "ELL":
        return _nbytes(fmt.vals) + _nbytes(fmt.cols) + vec
    if name == "WELL":
        return _nbytes(fmt.vals) + _nbytes(fmt.lidx) + fmt.vals.shape[0] * 128 * 4 + vec
    return int(fmt.n_non_zero_entries()) * 8 + vec


def roofline_spmv(fmt, x, hbm_bw: float, name: str | None = None,
                  inner: int = 200) -> KernelReport:
    """An SpMV path timed on the card against its traffic model at
    ``hbm_bw`` bytes/s."""
    from ..ops import spmv

    dt = time_chained_op(lambda v, m: spmv(m, v) * 5e-4, torch.as_tensor(x),
                         captures=(fmt,), inner=inner)
    nnz = int(fmt.n_non_zero_entries())
    return KernelReport(name=name or type(fmt).__name__, seconds=dt, nnz=nnz,
                        bytes_model=spmv_bytes_model(fmt), flops=2 * nnz, hbm_bw=hbm_bw)


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
