"""Timing and roofline accounting (counterpart of ``sparsemat_tpu/utils``)."""

from .profiling import KernelReport, roofline_spmv, sync, time_chained_op, trace_to

__all__ = ["KernelReport", "roofline_spmv", "time_chained_op", "sync", "trace_to"]
