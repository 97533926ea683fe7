"""host.freeze_s: host seconds of auto_format and the first product (which
builds the kernels' launch plans), synchronised."""


def read(run):
    return run["setup"]["freeze_s"]
