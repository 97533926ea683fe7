"""SlabELL / SlabPack SpMV and SpMM, and the SlabStream SpMV: the CUDA
kernels' wrappers, their plain versions and launch counters.  Counterpart of
the slab halves of two JAX modules: ``sparsemat_tpu/kernels/spmv.py``
(``slab_spmv_pallas``, ``slab_pack_spmv_pallas``, ``slab_stream_spmv_pallas``
and their ``*_xla`` oracles) and ``sparsemat_tpu/kernels/spmm.py``
(``slab_spmm_pallas``, ``slab_pack_spmm_pallas``, ``slab_spmm_xla``).

The SpMV and SpMM do not read the padded layout: each launches a row-group
kernel (``csrc/spmv.cu`` and ``csrc/spmm.cu``, see the notes there for
what they replace and what bounds them) once per product over the
matrix's compact plan (``kernels/_rowgroup.py``), one plan shared by both,
which holds the stored entries of every part and of every overflow level,
so a SlabPack with an overflow pack is one launch.  The TPU's per-part
calls and its ``_slab_pack_combine`` permutation have no counterpart.  The
plain versions keep the per-part loop and the permutation, so they and the
kernels are independent.  The SlabStream kernel (``csrc/slab.cu``) is one
launch of one CTA per row block over the block's chunks; the TPU's
SMEM-sized splits, chunk groups and resident y have no counterpart.

Dtypes: the values and x / B are cast to the accumulation dtype of the two
(bf16/f16 to f32) before the launch; the kernels run in f32 or f64.  One
difference of the row-group kernels from their plain versions: they read
no padding slot, so where x or B holds inf or NaN in a row that a padding
slot points at, they give what a CSR product gives (scipy, ``torch.mv``,
``torch.sparse.mm``) and not the slot's 0·inf = NaN; for a finite operand
the two agree.  A wrapper takes the plain version only when its tensors
lie on the CPU; on a CUDA tensor it launches its kernel or raises.  The
layout is checked once per matrix, when its plan is built, and the plans
are cached on it (``_rowgroup.plan_of``, ``_StreamPlan``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..formats.slab import SUBLANE, WINDOW, SlabELL, SlabPack, SlabStream
from ..types import FLOAT_DTYPES, accum_dtype
from .._build import load_cuda
from . import _rowgroup
from ._common import block_ranges, gather

#: kernel launches (plain versions do not count): one per product, any
#: number of overflow levels
LAUNCHES = {"slab_spmv": 0, "slab_spmm": 0, "slab_stream_spmv": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: cap on the plain SpMM's materialised (slots, columns) gather of B
_REF_GATHER_BUDGET = 1 << 29
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/slab.cu`` library (the SlabStream SpMV)."""
    global _lib
    if _lib is None:
        lib = load_cuda("slab")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_slab_stream_spmv_{s}")
            fn.argtypes = [vp, vp, vp, vp, vp, i64, i32, i64, i64, vp, vp, vp]
            fn.restype = i32
        lib.smt_slab_error_string.argtypes = [i32]
        lib.smt_slab_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# --- plain versions --------------------------------------------------------------

def _slab_cols(sl: SlabELL) -> torch.Tensor:
    """(n_rb, C, rb) int64 column of every slot."""
    w_of = torch.from_numpy(sl._window_of_cpos()).to(sl.vals.device).long()
    return sl.lidx.long() + (sl.win_lo.long()[:, None, None] + w_of[None, :, None]) * WINDOW


def _combine(pack: SlabPack, part_ys) -> torch.Tensor:
    """Each part's block rows put back in global block order (the static
    permutation of ``_slab_pack_combine``), cut to n_rows."""
    rb = pack.row_block
    ids = np.concatenate([np.asarray(i, np.int64) for i in pack.block_ids])
    inv = torch.from_numpy(np.argsort(ids)).to(part_ys[0].device)
    tail = tuple(part_ys[0].shape[1:])
    Y = torch.cat([y.reshape((y.shape[0] // rb, rb) + tail) for y in part_ys], dim=0)
    return Y[inv].reshape((Y.shape[0] * rb,) + tail)[: pack.shape[0]]


def slab_spmv_ref(sl: SlabELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: every slot's value times x at its column, summed over the
    C axis — the JAX package's ``slab_spmv_xla``."""
    adt = accum_dtype(torch.promote_types(sl.vals.dtype, x.dtype))
    xg = gather(x.to(adt), _slab_cols(sl), sl.shape[1])
    y = torch.sum(sl.vals.to(adt) * xg, dim=1)                  # (n_rb, rb)
    return y.reshape(-1)[: sl.shape[0]]


def slab_pack_spmv_ref(pack: SlabPack, x: torch.Tensor) -> torch.Tensor:
    """Per part, the permutation back to row order, plus the overflow —
    the JAX package's ``slab_pack_spmv_xla``."""
    y = _combine(pack, [slab_spmv_ref(p, x) for p in pack.parts])
    if pack.overflow is not None:
        y = y + slab_pack_spmv_ref(pack.overflow, x)
    return y


def slab_spmm_ref(sl: SlabELL, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B column by column as ``slab_spmv_ref`` (the JAX package's
    ``slab_spmm_xla``, a vmap of the SpMV over columns), B's columns taken
    in groups whose gather stays within ``_REF_GATHER_BUDGET``."""
    adt = accum_dtype(torch.promote_types(sl.vals.dtype, B.dtype))
    n_rb, _, rb = sl.vals.shape
    m = B.shape[1]
    cols = _slab_cols(sl)
    vals = sl.vals.to(adt)[..., None]
    g = max(_REF_GATHER_BUDGET // max(sl.nse * adt.itemsize, 1), 1)
    out = [torch.sum(vals * gather(B[:, j:j + g].to(adt), cols, sl.shape[1]), dim=1)
           for j in range(0, m, g)]                              # (n_rb, rb, g) each
    Y = torch.cat(out, dim=2) if out else torch.zeros((n_rb, rb, 0), dtype=adt,
                                                       device=B.device)
    return Y.reshape(n_rb * rb, m)[: sl.shape[0]]


def slab_pack_spmm_ref(pack: SlabPack, B: torch.Tensor) -> torch.Tensor:
    """Per part ``slab_spmm_ref``, the permutation back to row order, plus
    the overflow — as ``slab_pack_spmm_pallas`` composes them (the JAX
    package has no XLA oracle for it)."""
    Y = _combine(pack, [slab_spmm_ref(p, B) for p in pack.parts])
    if pack.overflow is not None:
        Y = Y + slab_pack_spmm_ref(pack.overflow, B)
    return Y


def slab_stream_spmv_ref(st: SlabStream, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: every chunk's slots times x at their columns, summed over
    the 8 sublanes, then added into the chunk's row block (a chunk aimed at
    a block past the last goes to a spare row and is dropped) — the JAX
    package's ``slab_stream_spmv_xla``."""
    n_rows, n_cols = st.shape
    rb = st.row_block
    n_rb = st.n_row_blocks
    adt = accum_dtype(torch.promote_types(st.vals.dtype, x.dtype))
    cols = st.win_id.long()[:, None, None] * WINDOW + st.lidx.long()
    contrib = torch.sum(st.vals.to(adt) * gather(x.to(adt), cols, n_cols), dim=1)
    y = torch.zeros((n_rb + 1, rb), dtype=adt, device=x.device)
    y.index_add_(0, st.blk_id.long().clamp(0, n_rb), contrib)
    return y[:n_rb].reshape(-1)[:n_rows]


# --- the kernels -----------------------------------------------------------------

def _parts(mat):
    """Every SlabELL of a SlabELL or SlabPack, overflow levels included."""
    if isinstance(mat, SlabELL):
        return [mat]
    return list(mat.parts) + (_parts(mat.overflow) if mat.overflow is not None else [])


def _check_layout(mat) -> None:
    """The parts' arrays on one CUDA device and float values: checked once
    per matrix, when its plan is built."""
    dev = mat.data.device
    parts = _parts(mat)
    if dev.type != "cuda" or any(t.device != dev for p in parts
                                 for t in (p.vals, p.lidx, p.win_lo)):
        raise ValueError(f"slab kernels: the kernels need every part on one CUDA device, "
                         f"got {dev}")
    if any(p.vals.dtype not in FLOAT_DTYPES for p in parts):
        raise TypeError(f"slab kernels: the CUDA kernels take float values, got {mat.dtype}")


def _check_operand(mat, X: torch.Tensor, kind: str, want: tuple) -> None:
    if X.device != mat.data.device:
        raise ValueError(f"{kind}: matrix on {mat.data.device} and operand on "
                         f"{X.device}; the kernels need both on one CUDA device")
    if X.dtype not in FLOAT_DTYPES:
        raise TypeError(f"{kind}: the CUDA kernels take a float operand, got {X.dtype}")
    if tuple(X.shape) != want or X.dim() != len(want):
        raise ValueError(f"{kind}: operand of shape {tuple(X.shape)} for a {mat.shape} "
                         f"matrix")


def _launch_spmv(mat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through ``rowgroup_spmv_kernel``, one launch per product."""
    _check_operand(mat, x, "slab_spmv", (mat.shape[1],))
    return _rowgroup.launch_spmv(_rowgroup.plan_of(mat, _check_layout), x, LAUNCHES,
                                 "slab_spmv")


def _launch_spmm(mat, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B through ``rowgroup_spmm_kernel``, one launch per product."""
    _check_operand(mat, B, "slab_spmm", (mat.shape[1], B.shape[-1]))
    return _rowgroup.launch(_rowgroup.plan_of(mat, _check_layout), B, LAUNCHES, "slab_spmm")


def _on_cpu(mat, X) -> bool:
    return mat.data.device.type == "cpu" and X.device.type == "cpu"


def slab_spmv(sl: SlabELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a SlabELL.  CUDA: one launch of ``rowgroup_spmv_kernel``
    over the plan; CPU: the plain version."""
    return slab_spmv_ref(sl, x) if _on_cpu(sl, x) else _launch_spmv(sl, x)


def slab_pack_spmv(pack: SlabPack, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a SlabPack.  CUDA: one launch of
    ``rowgroup_spmv_kernel`` over the plan of all parts and overflow
    levels; CPU: the plain version."""
    return slab_pack_spmv_ref(pack, x) if _on_cpu(pack, x) else _launch_spmv(pack, x)


def slab_spmm(sl: SlabELL, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B over a SlabELL.  CUDA: one launch of ``rowgroup_spmm_kernel``
    over the plan; CPU: the plain version."""
    return slab_spmm_ref(sl, B) if _on_cpu(sl, B) else _launch_spmm(sl, B)


def slab_pack_spmm(pack: SlabPack, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B over a SlabPack.  CUDA: one launch of
    ``rowgroup_spmm_kernel`` over the plan of all parts and overflow
    levels; CPU: the plain version."""
    return slab_pack_spmm_ref(pack, B) if _on_cpu(pack, B) else _launch_spmm(pack, B)


class _StreamPlan:
    """Each row block's chunk range over the chunks in block order, and that
    order where the layout's chunks are not already in it."""

    def __init__(self, st: SlabStream):
        dev = st.vals.device
        n, sub, rb = st.vals.shape
        if dev.type != "cuda" or any(t.device != dev for t in (st.lidx, st.win_id, st.blk_id)):
            raise ValueError(f"slab_stream_spmv: the kernel needs every array on one CUDA "
                             f"device, got {dev}")
        if st.vals.dtype not in FLOAT_DTYPES:
            raise TypeError(f"slab_stream_spmv: the CUDA kernel takes float values, got "
                            f"{st.vals.dtype}")
        if (sub != SUBLANE or rb != st.row_block or tuple(st.lidx.shape) != (n, SUBLANE, rb)
                or tuple(st.win_id.shape) != (n,) or tuple(st.blk_id.shape) != (n,)):
            raise ValueError("slab_stream_spmv: the arrays do not form a SlabStream layout")
        if rb % 32 or not 0 < rb <= 1024:
            raise ValueError(f"slab_stream_spmv: row block {rb} is not a multiple of 32 "
                             f"up to 1024")
        if st.lidx.dtype != torch.int32 or st.win_id.dtype != torch.int32:
            raise TypeError("slab_stream_spmv: lidx and win_id must be int32")
        if not all(t.is_contiguous() for t in (st.vals, st.lidx, st.win_id)):
            raise ValueError("slab_stream_spmv: the kernel needs contiguous arrays")
        if n and (int(st.lidx.min()) < 0 or int(st.lidx.max()) >= WINDOW
                  or int(st.win_id.min()) < 0):
            raise ValueError("slab_stream_spmv: lidx must lie in [0, 128) and win_id "
                             "be >= 0")
        self.n_rb = st.n_row_blocks
        ptr, order = block_ranges(st.host("blk_id"), self.n_rb)
        self.chunk_ptr = torch.from_numpy(ptr).to(dev)
        self.order = None if order is None else torch.from_numpy(order).to(dev)


def slab_stream_spmv(st: SlabStream, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a SlabStream.  CUDA: one launch of
    ``slab_stream_spmv_kernel``; CPU: the plain version."""
    if _on_cpu(st, x):
        return slab_stream_spmv_ref(st, x)
    n_rows, n_cols = st.shape
    if x.device != st.vals.device:
        raise ValueError(f"slab_stream_spmv: matrix on {st.vals.device} and vector on "
                         f"{x.device}; the kernel needs both on one CUDA device")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"slab_stream_spmv: the CUDA kernel takes a float vector, got "
                        f"{x.dtype}")
    if x.dim() != 1 or x.shape[0] != n_cols:
        raise ValueError(f"slab_stream_spmv: vector of shape {tuple(x.shape)} for a "
                         f"{st.shape} matrix")
    plan = st.__dict__.get("_stream_plan")
    if plan is None:
        plan = _StreamPlan(st)
        object.__setattr__(st, "_stream_plan", plan)
    adt = accum_dtype(torch.promote_types(st.vals.dtype, x.dtype))
    vals = st.vals.to(adt)
    x = x.to(adt).contiguous()
    y = torch.empty(n_rows, dtype=adt, device=x.device)
    if n_rows == 0:
        return y
    lib = _kernels()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"smt_slab_stream_spmv_{_SUFFIX[adt]}")(
            vals.data_ptr(), st.lidx.data_ptr(), st.win_id.data_ptr(),
            plan.chunk_ptr.data_ptr(), plan.order.data_ptr() if plan.order is not None else None,
            plan.n_rb, st.row_block, n_rows, n_cols, x.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"slab_stream_spmv: CUDA error {rc} "
                           f"({lib.smt_slab_error_string(rc).decode()})")
    LAUNCHES["slab_stream_spmv"] += 1
    return y
