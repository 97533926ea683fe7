"""SpMV and its fused forms (counterpart of ``sparsemat_tpu/ops/matvec.py``).

Dispatch by format: DIA goes to the DIA kernels (``kernels/dia.py``),
StripELL to the strip kernel (``kernels/strip.py``) and RouteStream to the
two route kernels (``kernels/route.py``); each launches on CUDA tensors and
takes its plain version on CPU tensors.  CSR and COO take the
stream path: gather x by column, multiply, and reduce each row's segment in
order.  The segmented reduction has no atomics (a scatter-add with
``index_add_`` would use them on CUDA), so reruns are bitwise equal.  The
other formats' branches are not ported yet.
"""

from __future__ import annotations

import torch

from ..formats.coo import COO
from ..formats.csr import CSR
from ..formats.dia import DIA
from ..formats.route import RouteStream
from ..formats.strip import StripELL
from ..kernels import dia as dia_kernels
from ..kernels import route as route_kernels
from ..kernels import strip as strip_kernels
from ..types import accum_dtype


def _check_dims(mat, x, what="spmv"):
    if x.shape[0] != mat.shape[1]:
        raise ValueError(
            f"{what}: dimension mismatch — matrix is {mat.shape}, operand has "
            f"leading dim {x.shape[0]}")


# --- CSR / COO stream path ---------------------------------------------------

def _stream_spmv(indptr, cols, vals, x):
    """Σ over each row's segment [indptr[i], indptr[i+1]) of vals·x[cols];
    entries past indptr[-1] (tail padding) are never read into a row."""
    adt = accum_dtype(torch.promote_types(vals.dtype, x.dtype))
    prod = vals.to(adt) * torch.index_select(x, 0, cols).to(adt)
    # indptr comes from a freeze (sorted, in range), so validation is skipped
    return torch.segment_reduce(prod, "sum", offsets=indptr, unsafe=True)


# --- public dispatch ---------------------------------------------------------

def spmv(mat, x, *, method: str | None = None) -> torch.Tensor:
    """y = A @ x.  ``method``: None (by format), 'strip' or 'route' (freeze
    to StripELL or RouteStream first, as the JAX package's methods do)."""
    x = torch.as_tensor(x)
    _check_dims(mat, x)
    if method not in (None, "strip", "route"):
        raise ValueError(f"spmv: method {method!r} is not ported")
    if isinstance(mat, StripELL) or method == "strip":
        st = mat if isinstance(mat, StripELL) else mat.to_strip()
        return strip_kernels.strip_spmv(st, x)
    if isinstance(mat, RouteStream) or method == "route":
        rs = mat if isinstance(mat, RouteStream) else mat.to_route()
        return route_kernels.route_spmv(rs, x)
    if isinstance(mat, DIA):
        return dia_kernels.dia_spmv(mat, x)
    if isinstance(mat, CSR):
        return _stream_spmv(mat.indptr, mat.indices, mat.data, x)
    if isinstance(mat, COO):
        coo = mat.sort()
        return _stream_spmv(coo.indptr(), coo.cols, coo.vals, x)
    raise TypeError(f"spmv: format {type(mat).__name__} is not ported")


def spmv_dot(mat, x):
    """(A @ x, x·(A @ x)) — CG's A·p and pᵀAp.  A square DIA fuses the dot
    into the SpMV kernel (one pass over the matrix); other formats (StripELL
    and RouteStream included, as in the JAX package) compose spmv and a
    sum."""
    x = torch.as_tensor(x)
    _check_dims(mat, x, "spmv_dot")
    if isinstance(mat, DIA) and mat.shape[0] == mat.shape[1]:
        return dia_kernels.dia_spmv_dot(mat, x)
    y = spmv(mat, x)
    return y, torch.sum(x.to(y.dtype) * y)


def spmv_chain(mat, x, k: int) -> torch.Tensor:
    """x ← Aᵏ x — k chained SpMVs (square A).  A DIA runs the whole chain in
    one kernel launch; other formats loop ``spmv``."""
    x = torch.as_tensor(x)
    _check_dims(mat, x, "spmv_chain")
    if isinstance(mat, DIA):
        return dia_kernels.dia_spmv_chain(mat, x, k)
    if mat.shape[0] != mat.shape[1]:
        raise ValueError(f"spmv_chain needs a square matrix, got {mat.shape}")
    # spmv returns the accumulation dtype (f32 for bf16/f16 inputs): promote
    # x up front so every step sees one dtype
    x = x.to(accum_dtype(torch.promote_types(mat.dtype, x.dtype)))
    for _ in range(int(k)):
        x = spmv(mat, x)
    return x
