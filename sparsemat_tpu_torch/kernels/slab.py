"""SlabELL / SlabPack SpMV and SpMM, and the SlabStream SpMV: the CUDA
kernels' wrappers, their plain versions and launch counters.  Counterpart of
the slab halves of two JAX modules: ``sparsemat_tpu/kernels/spmv.py``
(``slab_spmv_pallas``, ``slab_pack_spmv_pallas``, ``slab_stream_spmv_pallas``
and their ``*_xla`` oracles) and ``sparsemat_tpu/kernels/spmm.py``
(``slab_spmm_pallas``, ``slab_pack_spmm_pallas``, ``slab_spmm_xla``).

The SpMV kernels live in ``csrc/slab.cu`` (see the note there for what they
replace and what bounds them): one launch per level of the matrix (its
parts, then each overflow pack) over every block of every part, each result
written straight to its global rows, the overflow's added on top.  The TPU's
per-part calls and its ``_slab_pack_combine`` permutation have no
counterpart.  The SlabStream kernel is one launch of one CTA per row block
over the block's chunks; the TPU's SMEM-sized splits, chunk groups and
resident y have no counterpart.  The SpMM does not read the padded layout:
it launches the row-group kernel (``csrc/spmm.cu``) once per product over
the matrix's compact plan (``kernels/_rowgroup.py``), which holds the
stored entries of every part and of every overflow level, so a SlabPack
with an overflow pack is one launch.  The plain versions keep the per-part
loop and the permutation, so they and the kernels are independent.

Dtypes: the values and x / B are cast to the accumulation dtype of the two
(bf16/f16 to f32) before the launch; the kernels run in f32 or f64.  One
difference of the SpMM from its plain version: the kernel reads no padding
slot, so where B holds inf or NaN in a row that a padding slot points at,
it gives what a CSR SpMM gives (scipy, ``torch.sparse.mm``) and not the
slot's 0·inf = NaN; for a finite B the two agree.  A wrapper takes the
plain version only when its tensors lie on the CPU; on a CUDA tensor it
launches its kernel or raises.  The layout is checked once per matrix and
the launch plans cached on it (``_plan``, ``spmm_plan``).
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

#: kernel launches (plain versions do not count); a SlabPack with an
#: overflow pack launches the SpMV twice per product, the SpMM once
LAUNCHES = {"slab_spmv": 0, "slab_spmm": 0, "slab_stream_spmv": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: cap on the plain SpMM's materialised (slots, columns) gather of B
_REF_GATHER_BUDGET = 1 << 29
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/slab.cu`` library."""
    global _lib
    if _lib is None:
        lib = load_cuda("slab")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_slab_spmv_{s}")
            fn.argtypes = [vp, vp, vp, i32, i32, i64, i64, vp, vp, i32, vp]
            fn.restype = i32
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

def _levels(mat):
    """[(parts, block ids per part, rb), ...]: the matrix's parts, then each
    nested overflow pack's."""
    if isinstance(mat, SlabELL):
        return [((mat,), (tuple(range(mat.n_row_blocks)),), mat.row_block)]
    out = [(mat.parts, mat.block_ids, mat.row_block)]
    if mat.overflow is not None:
        if tuple(mat.overflow.shape) != tuple(mat.shape):
            raise ValueError("slab kernels: the overflow pack's shape differs from "
                             "the matrix's")
        out += _levels(mat.overflow)
    return out


def _part_table(parts, vals, wofs, device) -> torch.Tensor:
    """(n_parts, 6) int64 device table: the pointers of each part's vals /
    lidx / win_lo / per-slot window ids, then C and the part's first block
    in the flat grid."""
    first = np.cumsum([0] + [p.n_row_blocks for p in parts])
    rows = [[v.data_ptr(), p.lidx.data_ptr(), p.win_lo.data_ptr(), w.data_ptr(),
             p.c_total, int(f)] for p, v, w, f in zip(parts, vals, wofs, first)]
    return torch.tensor(rows, dtype=torch.int64).to(device)


class _Level:
    """One launch's table: parts, per-slot window ids, and the part index
    and global block id of every block of the flat grid."""

    def __init__(self, parts, block_ids, rb, first: bool, n_rows: int, device):
        for p, ids in zip(parts, block_ids):
            nb, c, prb = p.vals.shape
            if (prb != rb or tuple(p.lidx.shape) != (nb, c, rb)
                    or tuple(p.win_lo.shape) != (nb,) or len(ids) != nb
                    or sum(h for _, h in p.buckets) != c):
                raise ValueError("slab kernels: a part's arrays do not form a SlabELL "
                                 "layout")
            if p.lidx.dtype != torch.int32 or p.win_lo.dtype != torch.int32:
                raise TypeError("slab kernels: lidx and win_lo must be int32")
            if not all(t.is_contiguous() for t in (p.vals, p.lidx, p.win_lo)):
                raise ValueError("slab kernels: the kernels need contiguous part arrays")
        if rb % 32 or not 0 < rb <= 1024:
            raise ValueError(f"slab kernels: row block {rb} is not a multiple of 32 "
                             f"up to 1024")
        ids = np.concatenate([np.asarray(i, np.int64) for i in block_ids])
        srt = np.sort(ids)
        need = -(-n_rows // rb)
        if (ids.size and (srt[0] < 0 or srt[-1] >= 2 ** 31 or np.any(np.diff(srt) == 0))) \
                or (first and not np.array_equal(srt[:need], np.arange(need))):
            raise ValueError("slab kernels: every row block must be in exactly one part")
        self.parts = parts
        self.rb = rb
        self.n_blocks = int(ids.size)
        self.part_of = torch.from_numpy(np.concatenate(
            [np.full(p.n_row_blocks, i, np.int32) for i, p in enumerate(parts)])).to(device)
        self.block_ids = torch.from_numpy(ids.astype(np.int32)).to(device)
        self.wofs = [torch.from_numpy(p._window_of_cpos()).to(device) for p in parts]
        self.table = _part_table(parts, [p.vals for p in parts], self.wofs, device)

    def table_for(self, adt: torch.dtype):
        """The table over the parts' values cast to ``adt``, and the casts
        (kept alive by the caller until the launch is enqueued; the caching
        allocator keeps them until it has run on this stream)."""
        if adt == self.parts[0].vals.dtype:
            return self.table, None
        vals = [p.vals.to(adt) for p in self.parts]
        return _part_table(self.parts, vals, self.wofs, vals[0].device), vals


class _Plan:
    """The launch levels of a SlabELL or SlabPack, checked once."""

    def __init__(self, mat):
        dev = mat.data.device
        levels = _levels(mat)
        tensors = [t for parts, _, _ in levels for p in parts for t in (p.vals, p.lidx, p.win_lo)]
        if dev.type != "cuda" or any(t.device != dev for t in tensors):
            raise ValueError(f"slab kernels: the kernels need every part on one CUDA "
                             f"device, got {dev}")
        dtypes = {p.vals.dtype for parts, _, _ in levels for p in parts}
        if len(dtypes) != 1 or mat.dtype not in FLOAT_DTYPES:
            raise TypeError(f"slab kernels: the CUDA kernels take float values of one "
                            f"dtype, got {sorted(map(str, dtypes))}")
        self.levels = [_Level(parts, ids, rb, i == 0, mat.shape[0], dev)
                       for i, (parts, ids, rb) in enumerate(levels)]


def _plan(mat) -> _Plan:
    """The matrix's launch plan, cached on it (a frozen matrix's layout and
    values never change)."""
    plan = mat.__dict__.get("_slab_plan")
    if plan is None:
        plan = _Plan(mat)
        object.__setattr__(mat, "_slab_plan", plan)
    return plan


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
    """y = A @ x through ``slab_spmv_kernel``, one launch per level."""
    n_rows, n_cols = mat.shape
    _check_operand(mat, x, "slab_spmv", (n_cols,))
    plan = _plan(mat)
    adt = accum_dtype(torch.promote_types(mat.dtype, x.dtype))
    x = x.to(adt).contiguous()
    y = torch.empty((n_rows,), dtype=adt, device=x.device)
    if y.numel() == 0:
        return y
    lib = _kernels()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for i, lvl in enumerate(plan.levels):
        table, _casts = lvl.table_for(adt)
        with torch.cuda.device(x.device):
            rc = getattr(lib, f"smt_slab_spmv_{_SUFFIX[adt]}")(
                table.data_ptr(), lvl.part_of.data_ptr(), lvl.block_ids.data_ptr(),
                lvl.n_blocks, lvl.rb, n_rows, n_cols, x.data_ptr(), y.data_ptr(),
                int(i > 0), stream)
        if rc != 0:
            msg = lib.smt_slab_error_string(rc).decode()
            raise RuntimeError(f"slab_spmv: CUDA error {rc} ({msg})")
        LAUNCHES["slab_spmv"] += 1
    return y


def spmm_plan(mat) -> _rowgroup.Plan:
    """The row-group plan of a SlabELL or SlabPack (every part and every
    overflow level in one), built from ``to_coo`` on the matrix's device
    at first use and cached on it."""
    plan = mat.__dict__.get("_spmm_plan")
    if plan is None:
        coo = mat.to_coo()
        plan = _rowgroup.build(coo.rows, coo.cols, coo.vals, mat.shape)
        object.__setattr__(mat, "_spmm_plan", plan)
    return plan


def _launch_spmm(mat, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B through ``rowgroup_spmm_kernel``, one launch per product."""
    _check_operand(mat, B, "slab_spmm", (mat.shape[1], B.shape[-1]))
    parts = [p for parts, _, _ in _levels(mat) for p in parts]
    dev = mat.data.device
    if dev.type != "cuda" or any(t.device != dev for p in parts
                                 for t in (p.vals, p.lidx, p.win_lo)):
        raise ValueError(f"slab_spmm: the kernel needs every part on one CUDA device, "
                         f"got {dev}")
    if any(p.vals.dtype not in FLOAT_DTYPES for p in parts):
        raise TypeError(f"slab_spmm: the CUDA kernel takes float values, got {mat.dtype}")
    return _rowgroup.launch(spmm_plan(mat), B, LAUNCHES, "slab_spmm")


def _on_cpu(mat, X) -> bool:
    return mat.data.device.type == "cpu" and X.device.type == "cpu"


def slab_spmv(sl: SlabELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a SlabELL.  CUDA: one launch of ``slab_spmv_kernel``;
    CPU: the plain version."""
    return slab_spmv_ref(sl, x) if _on_cpu(sl, x) else _launch_spmv(sl, x)


def slab_pack_spmv(pack: SlabPack, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a SlabPack.  CUDA: one launch of ``slab_spmv_kernel``
    over all parts, one more per overflow pack; CPU: the plain version."""
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
