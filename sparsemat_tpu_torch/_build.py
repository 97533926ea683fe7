"""Build the port's native code from the repo's sources at first use.

Each shared library is compiled once into ``build/sparsemat_tpu_torch/`` at
the repo root, under a name keyed by the hash of its sources and command,
and loaded with ctypes.  The CUDA kernels (``csrc/*.cu``) are built with
nvcc for ``sm_90a`` and have a plain C interface, so no PyTorch headers are
compiled and a build takes seconds.  A missing compiler or a failed build
raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

from .utils import profiling

_PKG = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "sparsemat_tpu_torch")
CSRC_DIR = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def compile_shared(name: str, compiler: list[str], sources: list[str]) -> str:
    """Path of ``lib<name>_<hash>.so`` built from ``sources`` by
    ``compiler + [-o out] + sources``; compiled only when absent."""
    h = hashlib.sha256(" ".join(compiler).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    # build in a private directory and rename: concurrent builders (test
    # workers) never see a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp_so = os.path.join(td, "lib.so")
        proc = subprocess.run(compiler + ["-o", tmp_so] + sources,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed (rc {proc.returncode}):\n"
                f"{' '.join(compiler)}\n{proc.stderr}")
        os.replace(tmp_so, so_path)
    return so_path


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be built")
    return nvcc


def load_cuda(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first call; the
    first load is the set-up span ``freeze.build``)."""
    lib = _loaded.get(name)
    if lib is None:
        with profiling.span("freeze.build", setup=True):
            src = os.path.join(CSRC_DIR, f"{name}.cu")
            lib = ctypes.CDLL(compile_shared(name, [find_nvcc()] + NVCC_FLAGS, [src]))
        _loaded[name] = lib
    return lib
