"""kernel.matvec_roofline.solve: the roofline bound of one SpMV (roofline.py)
over the device time per call of a profiled burst of spmv_dot(A, p), the op
cg applies each iteration, summed over every device operation the burst
launched."""

import roofline


def read(run):
    b = run.get("burst")
    if not b or not b["count"]:
        return None
    return roofline.share_pct(run["bound_s"], b["device_s"] / b["ops"])
