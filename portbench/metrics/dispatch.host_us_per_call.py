"""dispatch.host_us_per_call: host µs a call of the program's ``ops.spmv``
span (the public ``spmv``, its dispatch and the kernel wrapper's launch),
over the profiled slice's calls."""

import programtrace


def read(run):
    s = programtrace.span("ops.spmv")
    if run["kind"] != "product" or run["columns"] != 1 or not s or not s["count"]:
        return None
    return 1e6 * s["total_s"] / s["count"]
