"""The program's own record of spans and counters, for the readers of
``program_span`` and ``program_counter`` metrics: ``trace_record()`` of
``sparsemat_tpu_torch.utils.profiling`` as the run left it, or None where
the program is not loaded (the plain reference in its place) or keeps no
such record.

The per-call spans and counters cover what ran while a profiler recorded
(the traced slice, and in a solve cell the ``spmv_dot`` burst); the set-up
spans (``freeze.*``) cover every freeze of the run."""

import sys

MODULE = "sparsemat_tpu_torch.utils.profiling"


def record():
    trace_record = getattr(sys.modules.get(MODULE), "trace_record", None)
    return trace_record() if trace_record is not None else None


def span(name):
    """The record's span ``name`` ({"count", "total_s", "self_s"}), or None."""
    rec = record()
    return rec["spans"].get(name) if rec is not None else None


def counter(name):
    """The record's counter ``name`` ({key: count}), or None."""
    rec = record()
    return rec["counters"].get(name) if rec is not None else None
