"""solver.fused_share: the solver loop's steps run by a body that commits
itself (CG's step kernels) over the steps it executed, in percent, over the
profiled solves, from the program's ``solver`` counters; None where the
program keeps no ``steps_fused`` counter."""

import programtrace


def read(run):
    c = programtrace.counter("solver")
    if (run["kind"] != "solve" or not c or not c.get("steps_executed")
            or "steps_fused" not in c):
        return None
    return 100.0 * c["steps_fused"] / c["steps_executed"]
