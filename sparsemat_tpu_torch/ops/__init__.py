"""Functional ops over sparse formats: SpMV, its fused dot and chain forms,
SpMM and Aᵀy (``rmatvec``).  The JAX package's ``ops/algebra.py`` (SpGEMM
and the rest of the matrix algebra) is not ported."""

from .matvec import rmatvec, spmm, spmv, spmv_chain, spmv_dot

__all__ = ["rmatvec", "spmm", "spmv", "spmv_chain", "spmv_dot"]
