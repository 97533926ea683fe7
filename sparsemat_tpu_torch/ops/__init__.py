"""Functional ops over sparse formats.  The slice ported so far: SpMV, its
fused dot and chain forms, and SpMM."""

from .matvec import spmm, spmv, spmv_chain, spmv_dot

__all__ = ["spmm", "spmv", "spmv_chain", "spmv_dot"]
