"""sparsemat_tpu_torch — the PyTorch + CUDA port of ``sparsemat_tpu``.

Ported so far: host assembly (``SparseBuilder``) or MatrixMarket input
(``io.load_mtx``) → freeze to ``CSR`` → freeze to ``DIA`` (banded),
``StripELL``, ``SlabELL`` or ``SlabPack`` (bounded-span scattered, the FEM
class), ``RouteStream`` (globally scattered, the circuit class) or ``ELL``
→ ``spmv`` / ``spmv_dot`` / ``spmv_chain`` → the solvers (CG/PCG, BiCGStab, GMRES, Chebyshev, Jacobi,
mixed-precision refinement) and the Jacobi / block-Jacobi preconditioners;
checkpoints of matrices and solves in the JAX package's file format
(``checkpoint``); ``spmm`` (``A @ B``) over ``BSR``, the slab formats,
DIA, ELL and the CSR/COO stream.  Formats are frozen dataclasses of tensors
on an explicit device; ops and solvers are plain functions.  The DIA,
StripELL, RouteStream, BSR and slab kernels are hand-written CUDA for
Hopper (``csrc/``), built at first use; on CPU tensors each takes its plain
PyTorch version.
This package imports neither jax nor ``sparsemat_tpu``.
"""

from . import checkpoint, formats, io, ops, solvers, vectors
from .builder import SparseBuilder
from .formats import (BSR, COO, CSR, DIA, ELL, RouteStream, SlabELL, SlabPack,
                      SparseFormat, StripELL)
from .ops import spmm, spmv, spmv_chain, spmv_dot
from .solvers import GMRES, BiCGStab, ConjugateGradient, Jacobi, SolveInfo
from .types import DEFAULT_INDEX_DTYPE
from .vectors import DenseVec, SparseVec, inner_prod, norm, norm_squared

__all__ = [
    "COO", "CSR", "DIA", "ELL", "BSR", "RouteStream", "StripELL", "SlabELL", "SlabPack",
    "SparseFormat", "SparseBuilder",
    "ConjugateGradient", "Jacobi", "BiCGStab", "GMRES", "SolveInfo", "solvers",
    "spmv", "spmv_dot", "spmv_chain", "spmm",
    "DenseVec", "SparseVec", "inner_prod", "norm", "norm_squared",
    "checkpoint", "formats", "io", "ops", "vectors", "eye", "from_dense",
]


def eye(dim: int, *, dtype=None, index_dtype=None, format: str = "csr",
        device=None):
    """Identity matrix."""
    import torch

    kwargs = dict(dtype=dtype or torch.float32,
                  index_dtype=index_dtype or DEFAULT_INDEX_DTYPE, device=device)
    if format == "csr":
        return CSR.eye(dim, **kwargs)
    if format == "coo":
        return COO.eye(dim, **kwargs)
    raise ValueError(f"unknown format {format!r}")


def from_dense(mat, *, format: str = "csr", device=None):
    """Convert a dense array to a sparse format."""
    if format == "csr":
        return CSR.from_dense(mat, device=device)
    if format == "coo":
        return COO.from_dense(mat, device=device)
    if format == "dia":
        return CSR.from_dense(mat, device=device).to_dia()
    raise ValueError(f"unknown format {format!r}")
