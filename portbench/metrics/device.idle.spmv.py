"""device.idle.spmv: the share of the profiled slice's wall time in which no
device operation ran, in percent."""


def read(run):
    s = run.get("slice")
    if not s or not s["count"]:
        return None
    return s["idle_pct"]
