"""dispatch.conversions_per_call: the format conversions that the
products' dispatch made at call time (the program's ``ops.conversions``
counter, all targets) over the ``ops.spmm`` calls, over the profiled
slice."""

import programtrace


def read(run):
    s, c = programtrace.span("ops.spmm"), programtrace.counter("ops.conversions")
    if run["kind"] != "product" or run["columns"] == 1 or not s or not s["count"] or c is None:
        return None
    return sum(c.values()) / s["count"]
