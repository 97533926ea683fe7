"""freeze.plan_s: host seconds of the program's ``freeze.plan`` spans (the
kernels' launch plans built at a matrix's first product), their own time:
a native library's load and build inside one (``freeze.build``) left
out."""

import programtrace


def read(run):
    s = programtrace.span("freeze.plan")
    return s["self_s"] if s else None
