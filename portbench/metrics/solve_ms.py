"""solve_ms: all the window's time over the solves completed in it (the
last solve started runs to its end): the time to a solution."""


def read(run):
    w = run.get("window")
    if run["kind"] != "solve" or "slice" in run or not w or not w["ops"]:
        return None
    return 1e3 * w["seconds"] / w["ops"]
