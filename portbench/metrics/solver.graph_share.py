"""solver.graph_share: the solver loop's steps replayed from a CUDA graph
over the steps it executed, in percent, over the profiled solves, from the
program's ``solver`` counters; None where the program keeps no
``steps_replayed`` counter."""

import programtrace


def read(run):
    c = programtrace.counter("solver")
    if (run["kind"] != "solve" or not c or not c.get("steps_executed")
            or "steps_replayed" not in c):
        return None
    return 100.0 * c["steps_replayed"] / c["steps_executed"]
