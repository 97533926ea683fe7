"""solver.host_us_per_step: host µs of the program's ``solver.block`` spans
(the enqueue of each block of the solver loop's steps, its host read of the
condition left out) over the steps executed, over the profiled solves."""

import programtrace


def read(run):
    s, c = programtrace.span("solver.block"), programtrace.counter("solver")
    if run["kind"] != "solve" or not s or not c or not c.get("steps_executed"):
        return None
    return 1e6 * s["total_s"] / c["steps_executed"]
