"""Timing, and the program's spans and counters (counterpart of
``sparsemat_tpu/utils``)."""

from .profiling import (reset_trace, span, sync, time_chained_op, trace_record, trace_to,
                        tracing)

__all__ = ["time_chained_op", "sync", "trace_to", "span", "tracing", "trace_record",
           "reset_trace"]
