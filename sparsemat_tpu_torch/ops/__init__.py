"""Functional ops over sparse formats: SpMV, its fused dot and chain forms,
SpMM, Aᵀy (``rmatvec``), the bilinear form lᵀAr (``inner_prod``), SpGEMM
and the matrix algebra (``add``, ``sub``, ``transpose``, the structure
predicates)."""

from .algebra import (DimensionError, add, extract_row, inner_prod, is_sorted, is_sorted_row,
                      is_symmetric, spgemm, sub, transpose)
from .matvec import rmatvec, spmm, spmv, spmv_chain, spmv_dot

__all__ = ["DimensionError", "add", "extract_row", "inner_prod", "is_sorted", "is_sorted_row",
           "is_symmetric", "rmatvec", "spgemm", "spmm", "spmv", "spmv_chain", "spmv_dot", "sub",
           "transpose"]
