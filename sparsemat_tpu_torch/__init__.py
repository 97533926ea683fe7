"""sparsemat_tpu_torch — the PyTorch + CUDA port of ``sparsemat_tpu``.

Ported so far: host assembly (``SparseBuilder``, ``RowVec``) or MatrixMarket input
(``io.load_mtx``) → freeze to ``CSR`` → freeze to ``DIA`` (banded),
``StripELL``, ``SlabELL``, ``SlabPack`` or ``SlabStream`` (bounded-span
scattered, the FEM class), ``RouteStream`` (globally scattered, the circuit
class), ``WELL`` (windowed ELL, the general-matrix format), ``ELL``, ``SELL``
or ``GELL``, or let ``auto_format`` choose → ``spmv`` / ``spmv_dot`` /
``spmv_chain`` / ``rmatvec`` → the solvers (CG/PCG, BiCGStab, GMRES,
Chebyshev, Jacobi, SOR / Gauss–Seidel, mixed-precision refinement) and the
Jacobi / block-Jacobi preconditioners; the bilinear form
``inner_prod(mat, l, r)``; SpGEMM (``spgemm``, ``A @ B`` of two sparse
matrices) and the matrix algebra (``add``/``sub``/``transpose``, ``A + B``,
``A - B``, ``A.T``, the structure predicates); the dtype policy
(``types.TypePolicy``); timing and roofline helpers (``utils.profiling``);
checkpoints of matrices and solves in the JAX package's file format
(``checkpoint``); ``spmm`` (``A @ B``) over ``BSR``, the slab
formats, DIA, GELL, ELL and the CSR/COO stream.  Formats are frozen
dataclasses of tensors on one device: an entry point that builds tensors
puts them on the current CUDA card unless given ``device=`` (``"cpu"`` asks
for the CPU), and raises where torch finds no card.  Ops and solvers are
plain functions.  The DIA, StripELL, RouteStream, BSR, slab, SlabStream and
WELL kernels are hand-written CUDA for Hopper (``csrc/``), built at first
use; on CPU tensors each takes its plain PyTorch version.  SpGEMM and the
SOR sweep run as PyTorch ops on the card (the reference has no TPU kernel
there).  ``PartitionedBuilder`` assembles block rows; ``parallel`` (imported
as ``sparsemat_tpu_torch.parallel``) partitions a frozen matrix by rows over
a ``torch.distributed`` device mesh, one rank a block, each rank's product
on the same CUDA kernels.
This package imports neither jax nor ``sparsemat_tpu``.
"""

from . import checkpoint, formats, io, ops, solvers, vectors
from .builder import PartitionedBuilder, SparseBuilder
from .formats import (BSR, COO, CSR, DIA, ELL, GELL, SELL, WELL, RouteStream, RowVec, SlabELL,
                      SlabPack, SlabStream, SparseFormat, StripELL, auto_format)
from .ops import (DimensionError, add, extract_row, inner_prod, is_sorted, is_sorted_row,
                  is_symmetric, rmatvec, spgemm, spmm, spmv, spmv_chain, spmv_dot, sub, transpose)
from .solvers import (GMRES, BiCGStab, BlockJacobiPreconditioner, ConjugateGradient, Jacobi,
                      JacobiPreconditioner, SolveInfo)
from .types import DEFAULT_INDEX_DTYPE
from .vectors import DenseVec, SparseVec, norm, norm_squared

__all__ = [
    "COO", "CSR", "DIA", "ELL", "SELL", "BSR", "GELL", "RouteStream", "StripELL",
    "SlabELL", "SlabPack", "SlabStream", "WELL", "RowVec", "SparseFormat", "SparseBuilder",
    "PartitionedBuilder",
    "auto_format",
    "ConjugateGradient", "Jacobi", "BiCGStab", "GMRES",
    "JacobiPreconditioner", "BlockJacobiPreconditioner", "SolveInfo", "solvers",
    "DimensionError",
    "spmv", "spmv_dot", "spmv_chain", "spmm", "spgemm", "rmatvec",
    "add", "sub", "transpose", "is_symmetric", "is_sorted", "is_sorted_row", "extract_row",
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
