"""host.assemble_s: host seconds of SparseBuilder.add_batch and
to_csr(device), synchronised (builder.py, csrc/assembly.cc)."""


def read(run):
    return run["setup"]["assemble_s"]
