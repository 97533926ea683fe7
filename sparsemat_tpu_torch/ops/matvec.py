"""SpMV, its fused forms, and SpMM (counterpart of
``sparsemat_tpu/ops/matvec.py``).

Dispatch by format, in the JAX package's order: DIA goes to the DIA kernels
(``kernels/dia.py``), StripELL to the strip kernel (``kernels/strip.py``),
RouteStream to the two route kernels (``kernels/route.py``), SlabPack and
SlabELL to the slab kernels (``kernels/slab.py``) and, for SpMM, BSR to the
BSR kernel (``kernels/spmm.py``); each launches on CUDA tensors and takes
its plain version on CPU tensors.  ELL takes dense gather sweeps; CSR and
COO take the stream path: gather by column, multiply, and reduce each row's
segment in order.  The segmented reduction has no atomics (a scatter-add
with ``index_add_`` would use them on CUDA), so reruns are bitwise equal.
WELL, SlabStream and GELL are not ported yet.
"""

from __future__ import annotations

import torch

from ..formats.bsr import BSR
from ..formats.coo import COO
from ..formats.csr import CSR
from ..formats.dia import DIA, dia_spmm
from ..formats.ell import ELL
from ..formats.route import RouteStream
from ..formats.slab import SlabELL, SlabPack
from ..formats.strip import StripELL
from ..kernels import dia as dia_kernels
from ..kernels import route as route_kernels
from ..kernels import slab as slab_kernels
from ..kernels import spmm as spmm_kernels
from ..kernels import strip as strip_kernels
from ..types import accum_dtype

_SPMV_METHODS = (None, "strip", "route", "slab_pack", "slab", "ell")
_SPMM_METHODS = (None, "pallas", "bsr", "dia", "slab_pack", "slab", "ell")
#: cap on the materialised (nnz, tile) gather of the stream SpMM, and on the
#: (n_rows, K, m) gather the CSR branch allows the ELL path (the JAX
#: package's 512 MB)
_SPMM_GATHER_BUDGET = 1 << 29


def _check_dims(mat, x, what="spmv"):
    if x.shape[0] != mat.shape[1]:
        raise ValueError(
            f"{what}: dimension mismatch — matrix is {mat.shape}, operand has "
            f"leading dim {x.shape[0]}")


def _not_ported(what, method):
    raise ValueError(f"{what}: method {method!r} is not ported")


# --- CSR / COO stream path ---------------------------------------------------

def _stream_spmv(indptr, cols, vals, x):
    """Σ over each row's segment [indptr[i], indptr[i+1]) of vals·x[cols];
    entries past indptr[-1] (tail padding) are never read into a row."""
    adt = accum_dtype(torch.promote_types(vals.dtype, x.dtype))
    prod = vals.to(adt) * torch.index_select(x, 0, cols).to(adt)
    # indptr comes from a freeze (sorted, in range), so validation is skipped
    return torch.segment_reduce(prod, "sum", offsets=indptr, unsafe=True)


def _stream_spmm_tiled(indptr, cols, vals, B):
    """Y = A @ B over the entry stream, B's columns in tiles sized so the
    (nse, tile) gather stays within ``_SPMM_GATHER_BUDGET``; each tile a
    row-segmented reduction (the sum of each row in entry order)."""
    adt = accum_dtype(torch.promote_types(vals.dtype, B.dtype))
    n_rows = indptr.shape[0] - 1
    m = B.shape[1]
    nse = vals.shape[0]
    mt = min(max(_SPMM_GATHER_BUDGET // (max(nse, 1) * adt.itemsize), 1), max(m, 1))
    va = vals.to(adt)[:, None]
    Y = torch.empty((n_rows, m), dtype=adt, device=B.device)
    for j in range(0, m, mt):
        Bg = torch.index_select(B[:, j:j + mt], 0, cols).to(adt)
        Y[:, j:j + mt] = torch.segment_reduce(va * Bg, "sum", offsets=indptr,
                                              axis=0, unsafe=True)
    return Y


# --- ELL path ----------------------------------------------------------------

def _ell_gather(ell: ELL, X):
    """X's rows at the ELL's columns, (n_rows_p, K, ...); every column is
    in range, and a matrix with no columns reads zeros."""
    if X.shape[0] == 0:
        return X.new_zeros(tuple(ell.cols.shape) + tuple(X.shape[1:]))
    return X[ell.cols.long()]


def _ell_spmv(ell: ELL, x):
    adt = accum_dtype(torch.promote_types(ell.vals.dtype, x.dtype))
    y = torch.sum(ell.vals.to(adt) * _ell_gather(ell, x).to(adt), dim=1)
    return y[: ell.n_rows]


def _ell_spmm(ell: ELL, B):
    adt = accum_dtype(torch.promote_types(ell.vals.dtype, B.dtype))
    y = torch.sum(ell.vals.to(adt)[:, :, None] * _ell_gather(ell, B).to(adt), dim=1)
    return y[: ell.n_rows]


# --- public dispatch ---------------------------------------------------------

def spmv(mat, x, *, method: str | None = None) -> torch.Tensor:
    """y = A @ x.  ``method``: None (by format), or 'strip', 'route',
    'slab_pack', 'slab' or 'ell' (freeze to that format first, as the JAX
    package's methods do)."""
    x = torch.as_tensor(x)
    _check_dims(mat, x)
    if method not in _SPMV_METHODS:
        _not_ported("spmv", method)
    if isinstance(mat, DIA):
        return dia_kernels.dia_spmv(mat, x)
    if isinstance(mat, StripELL) or method == "strip":
        st = mat if isinstance(mat, StripELL) else mat.to_strip()
        return strip_kernels.strip_spmv(st, x)
    if isinstance(mat, RouteStream) or method == "route":
        rs = mat if isinstance(mat, RouteStream) else mat.to_route()
        return route_kernels.route_spmv(rs, x)
    if isinstance(mat, SlabPack) or method == "slab_pack":
        pk = mat if isinstance(mat, SlabPack) else mat.to_slab_pack()
        return slab_kernels.slab_pack_spmv(pk, x)
    if isinstance(mat, SlabELL) or method == "slab":
        sl = mat if isinstance(mat, SlabELL) else mat.to_slab()
        return slab_kernels.slab_spmv(sl, x)
    if isinstance(mat, ELL) or method == "ell":
        return _ell_spmv(mat.to_ell(), x)
    if isinstance(mat, CSR):
        return _stream_spmv(mat.indptr, mat.indices, mat.data, x)
    # COO, and any other format (BSR) through COO, as in the JAX package
    coo = mat.to_coo().sort()
    return _stream_spmv(coo.indptr(), coo.cols, coo.vals, x)


def spmv_dot(mat, x):
    """(A @ x, x·(A @ x)) — CG's A·p and pᵀAp.  A square DIA fuses the dot
    into the SpMV kernel (one pass over the matrix); other formats (StripELL,
    RouteStream and the slab formats included, as in the JAX package)
    compose spmv and a sum."""
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


def spmm(mat, B, *, method: str | None = None) -> torch.Tensor:
    """Y = A @ B for dense B of shape (n_cols, m).  ``method``: None (by
    format), 'pallas' or 'bsr' (BSR freeze, the BSR kernel), 'dia',
    'slab_pack', 'slab' or 'ell'; 'gell' is not ported yet."""
    B = torch.as_tensor(B)
    _check_dims(mat, B, "spmm")
    if B.dim() != 2:
        raise ValueError(f"spmm: B must be (n_cols, m), got shape {tuple(B.shape)}")
    if method not in _SPMM_METHODS:
        _not_ported("spmm", method)
    if isinstance(mat, BSR) or method in ("pallas", "bsr"):
        return spmm_kernels.spmm_pallas(mat, B)
    if isinstance(mat, DIA) or method == "dia":
        return dia_spmm(mat if isinstance(mat, DIA) else mat.to_dia(), B)
    if isinstance(mat, SlabPack) or method == "slab_pack":
        pk = mat if isinstance(mat, SlabPack) else mat.to_slab_pack()
        return slab_kernels.slab_pack_spmm(pk, B)
    if isinstance(mat, SlabELL) or method == "slab":
        sl = mat if isinstance(mat, SlabELL) else mat.to_slab()
        return slab_kernels.slab_spmm(sl, B)
    if isinstance(mat, ELL) or method == "ell":
        return _ell_spmm(mat.to_ell(), B)
    if isinstance(mat, CSR):
        # the ELL gather where its padding is small and (n_rows, K, m) fits
        # the budget, else the column-tiled stream
        nnz = mat.n_non_zero_entries()
        ell_slots = mat.max_row_nnz() * mat.n_rows
        if (nnz and ell_slots <= 4 * nnz
                and ell_slots * B.shape[1] * 4 <= _SPMM_GATHER_BUDGET):
            return _ell_spmm(mat.to_ell(), B)
        return _stream_spmm_tiled(mat.indptr, mat.indices, mat.data, B)
    if isinstance(mat, COO):
        coo = mat.sort()
        return _stream_spmm_tiled(coo.indptr(), coo.cols, coo.vals, B)
    # any other format through CSR, so the ELL-or-stream choice applies
    return spmm(mat.to_csr(), B, method=method)
