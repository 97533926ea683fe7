"""solver.iters_per_solve: the mean SolveInfo.iterations over the profiled
solves."""


def read(run):
    w = run.get("window")
    if run["kind"] != "solve" or "slice" not in run or not w["ops"]:
        return None
    return sum(w["iterations"]) / w["ops"]
