"""setup_s: seconds from the process's start to the window's start
(imports, CUDA start, inputs made from the seed, assembly, freeze, the
first product, the preconditioner, the warm-up)."""


def read(run):
    return run["setup"]["setup_s"]
