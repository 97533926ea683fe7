"""The benchmark's own tests (run with ``python -m pytest portbench/tests``):
the harness's modules on the path, and the ``cuda`` marker.  Imports no
JAX."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where torch finds none")
