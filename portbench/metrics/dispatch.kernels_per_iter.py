"""dispatch.kernels_per_iter: the device operations the profiler recorded in
the profiled slice (kernels, copies and memsets, whatever their names) over
the solver iterations committed in it."""


def read(run):
    s, w = run.get("slice"), run.get("window")
    if run["kind"] != "solve" or not s or not s["count"] or not sum(w["iterations"]):
        return None
    return s["count"] / sum(w["iterations"])
