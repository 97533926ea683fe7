"""SpMV, its fused forms, SpMM and Aᵀy (counterpart of
``sparsemat_tpu/ops/matvec.py``).

Dispatch by format, in the JAX package's order.  DIA goes to the DIA
kernels (``kernels/dia.py``).  The planned formats (``PLANNED``: StripELL,
WELL, SlabELL, SlabPack, SlabStream, RouteStream, and BSR for its SpMM) run
each product on a card as one launch over the matrix's compact row-group
plan (``kernels/_rowgroup.py``): the row-group SpMV or SpMM, or for a
RouteStream's SpMV the merge-path kernel (``kernels/route.py``).  On CPU
tensors each takes its plain version, which the table names (for the SpMM
of StripELL, WELL, SlabStream and RouteStream, the JAX package's path
through CSR; for a BSR's SpMV, COO).  GELL takes one ELL gather sweep per
level, joined by gathers through its inverse row maps; ELL takes dense
gather sweeps; CSR and COO (and SELL, through COO for SpMV and CSR for
SpMM) take the stream path: gather by column, multiply, and reduce each
row's segment in order.  The segmented reduction has no atomics (a
scatter-add with ``index_add_`` would use them on CUDA), so reruns are
bitwise equal.
``rmatvec`` reduces by column the same way, over a column order of the
entries built once per matrix.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..formats.bsr import BSR
from ..formats.coo import COO
from ..formats.csr import CSR
from ..formats.dia import DIA, dia_spmm
from ..formats.dia import dia_spmv as dia_spmv_plain
from ..formats.ell import ELL
from ..formats.gell import GELL
from ..formats.route import RouteStream
from ..formats.slab import SlabELL, SlabPack, SlabStream
from ..formats.strip import StripELL
from ..formats.well import WELL
from ..kernels import _rowgroup
from ..kernels import dia as dia_kernels
from ..kernels import route as route_kernels
from ..kernels._common import check_operand
from ..kernels.route import route_spmv_ref
from ..kernels.slab import (slab_pack_spmm_ref, slab_pack_spmv_ref, slab_spmm_ref,
                            slab_spmv_ref, slab_stream_spmv_ref)
from ..kernels.spmm import bsr_spmm_ref
from ..kernels.strip import strip_spmv_ref
from ..kernels.well import well_spmv_ref
from ..types import accum_dtype
from ..utils import profiling


class Planned(NamedTuple):
    """How a planned format's products run: on CUDA tensors one launch over
    the matrix's plan, counted in ``_rowgroup.LAUNCHES`` under its key; on
    CPU tensors its plain version."""
    spmv: Optional[Callable]     # the plain SpMV; None: the SpMV goes through COO
    spmm: Optional[Callable]     # the plain SpMM; None: through CSR
    spmv_key: Optional[str]
    spmm_key: str
    merge: bool = False          # the SpMV launches the merge-path route_spmv_kernel


#: the planned formats, by class (a SlabPack counts under the SlabELL's keys)
PLANNED = {
    StripELL: Planned(strip_spmv_ref, None, "strip_spmv", "strip_spmm"),
    WELL: Planned(well_spmv_ref, None, "well_spmv", "well_spmm"),
    SlabELL: Planned(slab_spmv_ref, slab_spmm_ref, "slab_spmv", "slab_spmm"),
    SlabPack: Planned(slab_pack_spmv_ref, slab_pack_spmm_ref, "slab_spmv", "slab_spmm"),
    SlabStream: Planned(slab_stream_spmv_ref, None, "slab_stream_spmv", "slab_stream_spmm"),
    RouteStream: Planned(route_spmv_ref, None, "route_spmv", "route_spmm", merge=True),
    BSR: Planned(None, bsr_spmm_ref, None, "bsr_spmm"),
}

#: the formats ``method=`` names, in the order the dispatch tries them (after
#: ``pallas`` and DIA, and for SpMM BSR): a matrix whose own format comes
#: first keeps it, any other is frozen to the method's
_SPMV_FORMATS = {"strip": StripELL, "route": RouteStream, "slab_stream": SlabStream,
                 "slab_pack": SlabPack, "slab": SlabELL, "well": WELL, "gell": GELL,
                 "ell": ELL}
_SPMM_FORMATS = {"slab_pack": SlabPack, "slab": SlabELL, "gell": GELL, "ell": ELL}
_SPMV_METHODS = (None, "pallas", "dia", "dia_xla", *_SPMV_FORMATS)
_SPMM_METHODS = (None, "pallas", "bsr", "dia", *_SPMM_FORMATS)
#: cap on the materialised (nnz, tile) gather of the stream SpMM, and on the
#: (n_rows, K, m) gather the CSR branch allows the ELL path (the JAX
#: package's 512 MB)
_SPMM_GATHER_BUDGET = 1 << 29


def _check_dims(mat, x, what="spmv"):
    if x.shape[0] != mat.shape[1]:
        raise ValueError(
            f"{what}: dimension mismatch — matrix is {mat.shape}, operand has "
            f"leading dim {x.shape[0]}")


def _unknown(what, method):
    raise ValueError(f"{what}: unknown method {method!r}")


def _to(mat, fmt: str):
    """``mat.to_<fmt>()``, a conversion that the dispatch makes at call
    time: counted by target in ``ops.conversions`` while tracing is on."""
    profiling.count(profiling.CONVERSIONS, fmt)
    return getattr(mat, f"to_{fmt}")()


def _by_method(mat, method, formats: dict):
    """``mat`` as the branch of ``method`` takes it: frozen to the method's
    format unless the matrix's own format comes first in ``formats``."""
    for name, cls in formats.items():
        if isinstance(mat, cls):
            return mat
        if name == method:
            return _to(mat, name)
    return mat


# --- the planned formats -----------------------------------------------------

def planned_spmv(mat, x, launches: Optional[dict] = None,
                 name: Optional[str] = None) -> torch.Tensor:
    """y = A @ x over a planned format.  CUDA: one launch over its plan,
    counted in ``launches[name]``, by default ``_rowgroup.LAUNCHES`` under
    the format's key (the merge-path launch always there); CPU: its plain
    version."""
    entry = PLANNED[type(mat)]
    if mat.device.type == "cpu" and x.device.type == "cpu":
        return entry.spmv(mat, x)
    name = name or entry.spmv_key
    check_operand(x, mat.device, mat.shape, name, (mat.shape[1],))
    plan = _rowgroup.plan_of(mat)
    if entry.merge:
        return route_kernels.launch(plan, plan.merge, x)
    return _rowgroup.launch_spmv(plan, x, launches or _rowgroup.LAUNCHES, name)


def _planned_spmm(mat, B, entry: Planned) -> torch.Tensor:
    """Y = A @ B over a planned format.  CUDA: one launch of the row-group
    SpMM over its plan; CPU: its plain version, or the CSR path (a
    conversion a call)."""
    if mat.device.type == "cpu" and B.device.type == "cpu":
        if entry.spmm is None:
            return _spmm(_to(mat, "csr"), B, None)
        return entry.spmm(mat, B)
    check_operand(B, mat.device, mat.shape, entry.spmm_key, (mat.shape[1], B.shape[1]))
    return _rowgroup.launch(_rowgroup.plan_of(mat), B, _rowgroup.LAUNCHES, entry.spmm_key)


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


# --- GELL ladder path (no scatter anywhere: see formats/gell.py) -------------

def _join(y, yl, inv):
    """y + yl[inv], where inv == len(yl) (a row absent from the level)
    reads 0."""
    pad = yl.new_zeros((1,) + tuple(yl.shape[1:]))
    return y + torch.cat([yl, pad])[inv.long()]


def _gell_spmv(g: GELL, x):
    y = _ell_spmv(g.levels[0], x)
    for lvl, inv in zip(g.levels[1:], g.inv_maps):
        y = _join(y, _ell_spmv(lvl, x), inv)
    return y


def _gell_spmm(g: GELL, B):
    Y = _ell_spmm(g.levels[0], B)
    for lvl, inv in zip(g.levels[1:], g.inv_maps):
        Y = _join(Y, _ell_spmm(lvl, B), inv)
    return Y


# --- public dispatch ---------------------------------------------------------

def spmv(mat, x, *, method: str | None = None) -> torch.Tensor:
    """y = A @ x.  ``method``: None (by format), or one of 'pallas' (any
    format frozen to WELL, then the WELL kernel), 'dia' (the DIA kernel),
    'dia_xla' (the plain DIA SpMV on any device), 'strip', 'route',
    'slab_stream', 'slab_pack', 'slab', 'well', 'gell' or 'ell' (freeze to
    that format first, as the JAX package's methods do).  A call is the
    span ``ops.spmv`` while tracing is on."""
    if not profiling.on():      # spares the no-op span its two method calls a product
        return _spmv(mat, x, method)
    with profiling.span("ops.spmv"):
        return _spmv(mat, x, method)


def _spmv(mat, x, method):
    x = torch.as_tensor(x)
    _check_dims(mat, x)
    if method not in _SPMV_METHODS:
        _unknown("spmv", method)
    if method == "pallas":
        return planned_spmv(mat if isinstance(mat, WELL) else _to(mat, "well"), x)
    if isinstance(mat, DIA) or method in ("dia", "dia_xla"):
        dia = mat if isinstance(mat, DIA) else _to(mat, "dia")
        if method == "dia_xla":
            return dia_spmv_plain(dia, x)
        return dia_kernels.dia_spmv(dia, x)
    if method is not None:
        mat = _by_method(mat, method, _SPMV_FORMATS)
    entry = PLANNED.get(type(mat))
    if entry is not None and entry.spmv is not None:
        return planned_spmv(mat, x)
    if isinstance(mat, GELL):
        return _gell_spmv(mat, x)
    if isinstance(mat, ELL):
        return _ell_spmv(mat, x)
    if isinstance(mat, CSR):
        return _stream_spmv(mat.indptr, mat.indices, mat.data, x)
    # COO, and any other format (BSR, SELL) through COO, as in the JAX package
    coo = (mat if isinstance(mat, COO) else _to(mat, "coo")).sort()
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
    'slab_pack', 'slab', 'gell' or 'ell'.  StripELL, WELL, SlabStream and
    RouteStream take the row-group SpMM over their plan on a card and go
    through CSR on the CPU, as in the JAX package; SELL, which has no plan,
    goes through CSR everywhere.  A call is the span ``ops.spmm`` while
    tracing is on."""
    if not profiling.on():      # spares the no-op span its two method calls a product
        return _spmm(mat, B, method)
    with profiling.span("ops.spmm"):
        return _spmm(mat, B, method)


def _spmm(mat, B, method):
    B = torch.as_tensor(B)
    _check_dims(mat, B, "spmm")
    if B.dim() != 2:
        raise ValueError(f"spmm: B must be (n_cols, m), got shape {tuple(B.shape)}")
    if method not in _SPMM_METHODS:
        _unknown("spmm", method)
    if isinstance(mat, BSR) or method in ("pallas", "bsr"):
        if not isinstance(mat, BSR):
            profiling.count(profiling.CONVERSIONS, "bsr")
            mat = BSR.from_csr(mat.to_csr())
        return _planned_spmm(mat, B, PLANNED[BSR])
    if isinstance(mat, DIA) or method == "dia":
        return dia_spmm(mat if isinstance(mat, DIA) else _to(mat, "dia"), B)
    if method is not None:
        mat = _by_method(mat, method, _SPMM_FORMATS)
    entry = PLANNED.get(type(mat))
    if entry is not None:
        return _planned_spmm(mat, B, entry)
    if isinstance(mat, GELL):
        return _gell_spmm(mat, B)
    if isinstance(mat, ELL):
        return _ell_spmm(mat, B)
    if isinstance(mat, CSR):
        # the ELL gather where its padding is small and (n_rows, K, m) fits
        # the budget, else the column-tiled stream
        nnz = mat.n_non_zero_entries()
        ell_slots = mat.max_row_nnz() * mat.n_rows
        if (nnz and ell_slots <= 4 * nnz
                and ell_slots * B.shape[1] * 4 <= _SPMM_GATHER_BUDGET):
            return _ell_spmm(_to(mat, "ell"), B)
        return _stream_spmm_tiled(mat.indptr, mat.indices, mat.data, B)
    if isinstance(mat, COO):
        coo = mat.sort()
        return _stream_spmm_tiled(coo.indptr(), coo.cols, coo.vals, B)
    # any other format (SELL) through CSR, so the ELL-or-stream choice applies
    return _spmm(_to(mat, "csr"), B, None)


def _column_order(mat):
    """(rows, col offsets, vals) of the matrix's stored entries in column
    order (a stable sort, so each column keeps the COO's entry order), with
    padding and out-of-range entries dropped; built once per matrix and
    cached on it (a frozen matrix's layout and values never change)."""
    cached = mat.__dict__.get("_column_order")
    if cached is not None:
        return cached
    n_rows, n_cols = mat.shape
    coo = mat.to_coo()
    rows, cols = coo.rows.long(), coo.cols.long()
    keep = (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < n_cols)
    rows, cols, vals = rows[keep], cols[keep], coo.vals[keep]
    order = torch.sort(cols, stable=True).indices
    counts = torch.bincount(cols, minlength=n_cols)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    cached = (rows[order], offsets, vals[order])
    object.__setattr__(mat, "_column_order", cached)
    return cached


def rmatvec(mat, y) -> torch.Tensor:
    """x = Aᵀ @ y without building the transpose: each column's entries
    times y at their rows, reduced per column in a fixed order (no atomics,
    so reruns are bitwise equal on a card as on the host)."""
    y = torch.as_tensor(y)
    if y.dim() != 1 or y.shape[0] != mat.shape[0]:
        raise ValueError(f"rmatvec: matrix is {mat.shape}, operand {tuple(y.shape)}")
    rows, offsets, vals = _column_order(mat)
    adt = accum_dtype(torch.promote_types(vals.dtype, y.dtype))
    prod = vals.to(adt) * torch.index_select(y, 0, rows).to(adt)
    return torch.segment_reduce(prod, "sum", offsets=offsets, unsafe=True)
