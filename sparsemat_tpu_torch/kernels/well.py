"""WELL SpMV: the CUDA kernel's wrapper, its plain version and launch
counter (counterpart of the WELL half of ``sparsemat_tpu/kernels/spmv.py``:
``well_spmv_pallas`` and ``well_spmv_xla``).

The CUDA kernel lives in ``csrc/well.cu`` (see the note there for what it
replaces and what bounds it): one launch, one warp per segment of at most
``SEG_SLOTS`` slots of one row block's tiles, the segments of a block
summed in a fixed order.  The wrapper's plan cuts the segments once per
matrix (``_Plan``, cached on the matrix; ``segments`` is its host half, which
the CPU tests replay); the TPU's ``chunks`` (one call per SMEM-sized tile
range) have no counterpart.

Dtypes: the values and x are cast to the accumulation dtype of the two
(bf16/f16 to f32) before the launch; the kernel runs in f32 or f64.  The
wrapper takes the plain version only when its tensors lie on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..formats.well import ROW_BLOCK, WELL, WINDOW
from ..types import FLOAT_DTYPES, accum_dtype
from .._build import load_cuda
from ._common import block_ranges, gather

#: kernel launches (the plain version does not count)
LAUNCHES = {"well_spmv": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: slots a segment (one warp's share of a row block) holds at most: short
#: enough that the circuit operator's heaviest row block (1,276 tiles) is
#: spread over ~60 warps, long enough that most blocks are one segment
SEG_SLOTS = 2048
_lib = None


def reset_launches() -> None:
    LAUNCHES["well_spmv"] = 0


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/well.cu`` library."""
    global _lib
    if _lib is None:
        lib = load_cuda("well")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_well_spmv_{s}")
            fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, i64, i64, vp, vp, vp,
                           vp, vp]
            fn.restype = i32
        lib.smt_well_error_string.argtypes = [i32]
        lib.smt_well_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# --- plain version ---------------------------------------------------------------

def well_spmv_ref(well: WELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: each tile's slots times x at their columns, summed over K,
    then added into the tile's row block (a tile aimed past the last block
    is dropped) — the JAX package's ``well_spmv_xla``."""
    n_rows, n_cols = well.shape
    n_rb = -(-n_rows // ROW_BLOCK)
    adt = accum_dtype(torch.promote_types(well.vals.dtype, x.dtype))
    cols = well.tile_wins.long()[:, None, None] * WINDOW + well.lidx.long()
    partial = torch.sum(well.vals.to(adt) * gather(x.to(adt), cols, n_cols), dim=2)
    y = torch.zeros((n_rb + 1, ROW_BLOCK), dtype=adt, device=x.device)
    y.index_add_(0, well.tile_rows.long().clamp(0, n_rb), partial)
    return y[:n_rb].reshape(-1)[:n_rows]


# --- the kernel ------------------------------------------------------------------

def segments(tile_rows, n_rb: int, slots: int, seg_slots: int = SEG_SLOTS):
    """The kernel's work split, from each tile's row block (in row-block
    order; tiles of a block past the last are dropped): (seg_ptr, seg_block,
    seg_multi, multi_first, multi_count).  Each row block's tiles are cut
    into segments of at most max(1, seg_slots // slots) tiles, a block with
    no tiles into one empty segment; seg_multi is -1 for a block's only
    segment and otherwise the block's index among the blocks of several,
    whose segments are multi_first .. multi_first + multi_count - 1."""
    rows = np.asarray(tile_rows, np.int64)
    ptr = np.searchsorted(rows, np.arange(n_rb + 1))
    per = max(1, seg_slots // slots)
    n_tiles = np.diff(ptr)
    n_seg_b = np.maximum(1, -(-n_tiles // per))
    first = np.cumsum(n_seg_b) - n_seg_b
    seg_block = np.repeat(np.arange(n_rb), n_seg_b)
    seg_start = ptr[seg_block] + (np.arange(seg_block.size) - first[seg_block]) * per
    seg_ptr = np.append(seg_start, ptr[n_rb]).astype(np.int64)
    multi = n_seg_b > 1
    multi_id = np.full(n_rb, -1, np.int64)
    multi_id[multi] = np.arange(int(multi.sum()))
    return (seg_ptr, seg_block.astype(np.int32), multi_id[seg_block].astype(np.int32),
            first[multi].astype(np.int32), n_seg_b[multi].astype(np.int32))


class _Plan:
    """The segments of the launch, and the layout in row-block order: the
    matrix's own arrays, or (for tiles that arrive out of that order) a
    copy gathered once by a stable sort of tile_rows."""

    def __init__(self, well: WELL):
        dev = well.vals.device
        n_tiles, rbk, k = well.vals.shape
        if dev.type != "cuda" or any(t.device != dev for t in
                                     (well.lidx, well.tile_rows, well.tile_wins)):
            raise ValueError(f"well_spmv: the kernel needs every array on one CUDA "
                             f"device, got {dev}")
        if well.vals.dtype not in FLOAT_DTYPES:
            raise TypeError(f"well_spmv: the CUDA kernel takes float values, got "
                            f"{well.vals.dtype}")
        if (rbk != ROW_BLOCK or tuple(well.lidx.shape) != (n_tiles, ROW_BLOCK, k)
                or tuple(well.tile_rows.shape) != (n_tiles,)
                or tuple(well.tile_wins.shape) != (n_tiles,) or not 0 < k <= WINDOW):
            raise ValueError("well_spmv: the arrays do not form a WELL layout")
        if well.lidx.dtype != torch.int32 or well.tile_wins.dtype != torch.int32:
            raise TypeError("well_spmv: lidx and tile_wins must be int32")
        if n_tiles and (int(well.lidx.min()) < 0 or int(well.lidx.max()) >= WINDOW
                        or int(well.tile_wins.min()) < 0):
            raise ValueError("well_spmv: lidx must lie in [0, 128) and tile_wins be >= 0")
        self.n_rb = -(-well.shape[0] // ROW_BLOCK)
        rows = well.host("tile_rows").astype(np.int64)
        _, order = block_ranges(rows, self.n_rb)
        self.vals, self.lidx, self.tile_wins = well.vals, well.lidx, well.tile_wins
        if order is not None:
            idx = torch.from_numpy(order).to(dev)
            self.vals, self.lidx, self.tile_wins = (well.vals[idx], well.lidx[idx],
                                                    well.tile_wins[idx])
            rows = rows[order]
        self.vals, self.lidx, self.tile_wins = (t.contiguous() for t in
                                                (self.vals, self.lidx, self.tile_wins))
        seg = segments(rows, self.n_rb, ROW_BLOCK * k, SEG_SLOTS)
        self.n_seg, self.n_multi = int(seg[1].size), int(seg[3].size)
        (self.seg_ptr, self.seg_block, self.seg_multi, self.multi_first,
         self.multi_count) = (torch.from_numpy(a).to(dev) for a in seg)


def _plan(well: WELL) -> _Plan:
    """The matrix's launch plan, cached on it (a frozen matrix's layout and
    values never change)."""
    plan = well.__dict__.get("_well_plan")
    if plan is None:
        plan = _Plan(well)
        object.__setattr__(well, "_well_plan", plan)
    return plan


def _launch(well: WELL, x: torch.Tensor) -> torch.Tensor:
    n_rows, n_cols = well.shape
    if x.device != well.vals.device:
        raise ValueError(f"well_spmv: matrix on {well.vals.device} and vector on "
                         f"{x.device}; the kernel needs both on one CUDA device")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"well_spmv: the CUDA kernel takes a float vector, got {x.dtype}")
    if x.dim() != 1 or x.shape[0] != n_cols:
        raise ValueError(f"well_spmv: vector of shape {tuple(x.shape)} for a "
                         f"{well.shape} matrix")
    plan = _plan(well)
    adt = accum_dtype(torch.promote_types(well.vals.dtype, x.dtype))
    vals = plan.vals.to(adt)
    x = x.to(adt).contiguous()
    y = torch.empty(n_rows, dtype=adt, device=x.device)
    if n_rows == 0:
        return y
    partial = tickets = None
    if plan.n_multi:
        partial = torch.empty(plan.n_seg * ROW_BLOCK, dtype=adt, device=x.device)
        tickets = torch.zeros(plan.n_multi, dtype=torch.int32, device=x.device)
    lib = _kernels()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"smt_well_spmv_{_SUFFIX[adt]}")(
            vals.data_ptr(), plan.lidx.data_ptr(), plan.tile_wins.data_ptr(),
            plan.seg_ptr.data_ptr(), plan.seg_block.data_ptr(), plan.seg_multi.data_ptr(),
            plan.multi_first.data_ptr(), plan.multi_count.data_ptr(), plan.n_seg,
            well.k_tile, n_rows, n_cols, x.data_ptr(), y.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            tickets.data_ptr() if tickets is not None else None,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"well_spmv: CUDA error {rc} "
                           f"({lib.smt_well_error_string(rc).decode()})")
    LAUNCHES["well_spmv"] += 1
    return y


def well_spmv(well: WELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a WELL.  CUDA: one launch of ``well_spmv_kernel``;
    CPU: the plain version."""
    if well.vals.device.type == "cpu" and x.device.type == "cpu":
        return well_spmv_ref(well, x)
    return _launch(well, x)

