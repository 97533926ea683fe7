"""kernel.gmres_step_roofline: the least time of the profiled solves'
committed GMRES steps (``gmres_roofline.py``: one SpMV each at the roofline
bound of ``roofline.py``, the basis rows that Gram–Schmidt projects against
read twice and the new row written) over the device time of the profiled
slice, every device operation summed, in percent; from the program's
``solver`` counters, None where the program keeps no ``arnoldi_rows``."""

import gmres_roofline
import programtrace
import roofline


def read(run):
    s, c = run.get("slice"), programtrace.counter("solver")
    if run["kind"] != "solve" or not s or not s["count"] or not c or not c.get("arnoldi_rows"):
        return None
    floor = gmres_roofline.floor_s(c["steps_committed"], run["bound_s"], c["arnoldi_rows"],
                                   c["arnoldi_bytes"])
    return roofline.share_pct(floor, s["device_s"])
