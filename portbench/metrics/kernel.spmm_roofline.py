"""kernel.spmm_roofline: the roofline bound of one SpMM (roofline.py) over
the device time per call of the profiled slice's own spmm calls, summed
over every device operation the slice launched."""

import roofline


def read(run):
    s = run.get("slice")
    if run["kind"] != "product" or run["columns"] == 1 or not s or not s["count"]:
        return None
    return roofline.share_pct(run["bound_s"], s["device_s"] / run["window"]["ops"])
