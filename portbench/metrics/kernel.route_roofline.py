"""kernel.route_roofline: the roofline bound of one SpMV (roofline.py) over
the device time a call of the operations named ``route_spmv_kernel`` in a
profiled burst of spmv_dot(A, p): the merge-path RouteStream SpMV alone,
without the dot's multiply and sum."""

import roofline

KERNEL = "route_spmv_kernel"


def read(run):
    b = run.get("burst")
    if not b or not b["count"]:
        return None
    device_s = sum(t for name, t in b["device_ops"] if KERNEL in name)
    return roofline.share_pct(run["bound_s"], device_s / b["ops"])
