"""Functional ops over sparse formats: SpMV, its fused dot and chain forms,
SpMM, Aᵀy (``rmatvec``) and the bilinear form lᵀAr (``inner_prod``).  The
rest of the JAX package's ``ops/algebra.py`` (SpGEMM and the matrix
algebra) is not ported."""

from .algebra import inner_prod
from .matvec import rmatvec, spmm, spmv, spmv_chain, spmv_dot

__all__ = ["inner_prod", "rmatvec", "spmm", "spmv", "spmv_chain", "spmv_dot"]
