"""Hand-written CUDA kernels for Hopper, their bindings and plain PyTorch
versions, and their launch counters (``kernels/dia.py``; every launch over
a row-group plan in ``kernels/_rowgroup.py``).  Kernels are built from
``csrc/`` at first use (``_build.py``)."""
