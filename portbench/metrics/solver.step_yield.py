"""solver.step_yield: the solver loop's steps committed over the steps it
executed, in percent, over the profiled solves (``solvers._while`` runs
blocks of 32 steps and masks those past the loop's exit), from the
program's ``solver`` counters."""

import programtrace


def read(run):
    c = programtrace.counter("solver")
    if run["kind"] != "solve" or not c or not c.get("steps_executed"):
        return None
    return 100.0 * c["steps_committed"] / c["steps_executed"]
