"""freeze.format_s: host seconds of the program's ``freeze.auto_format``
spans (choosing the compute format and freezing to it), over the run's
set-up."""

import programtrace


def read(run):
    s = programtrace.span("freeze.auto_format")
    return s["total_s"] if s else None
