"""StripELL SpMV: the CUDA kernel's wrapper, its plain version and launch
counter (counterpart of ``sparsemat_tpu/kernels/strip.py``).

The CUDA kernel lives in ``csrc/strip.cu`` (see the note there for what it
replaces and what bounds it): one launch per SpMV over every block of every
class part, each result written straight to its rows, so the TPU's
per-part launches and its ``_combine`` permutation are fused away.  The
plain version keeps the per-part loop and ``_combine``, so the two are
independent.

Dtypes: the values and x are cast to the accumulation dtype of the two
(``accum_dtype(promote_types(...))``, so bf16/f16 to f32) before the
launch, as the JAX wrapper casts them; the kernel runs in f32 or f64.  The
wrapper takes the plain version only when its tensors lie on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..formats.strip import RB, WINDOW, StripELL
from ..types import FLOAT_DTYPES, accum_dtype
from .._build import load_cuda

#: kernel launches (plain versions do not count)
LAUNCHES = {"strip_spmv": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: most strips a block can have (64 levels × 128 windows): bounds the
#: kernel's shared-memory copy of a block's wrel row to 32 KB
MAX_STRIPS = 64 * WINDOW
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/strip.cu`` library."""
    global _lib
    if _lib is None:
        lib = load_cuda("strip")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_strip_spmv_{s}")
            fn.argtypes = [vp, vp, vp, i32, i32, i64, i64, vp, vp, i32, vp]
            fn.restype = i32
        lib.smt_strip_error_string.argtypes = [i32]
        lib.smt_strip_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# --- plain version -------------------------------------------------------------

def _combine(st: StripELL, part_ys) -> torch.Tensor:
    """Static block-granular recombination of the per-part (nb, 128)
    results into y (the trailing group pad sorts past n_rows)."""
    ids = np.concatenate([np.asarray(p.block_ids, np.int64) for p in st.parts])
    inv = torch.from_numpy(np.argsort(ids)).to(part_ys[0].device)
    Y = torch.cat(part_ys, dim=0)
    return Y[inv].reshape(-1)[: st.shape[0]]


def strip_spmv_ref(st: StripELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x per class part, then ``_combine`` — the plain version of
    the kernel (the JAX package's ``strip_spmv_xla``).  A column ≥ n_cols
    reads 0, as the oracle's fill-mode gather does."""
    adt = accum_dtype(torch.promote_types(st.dtype, x.dtype))
    n_cols = st.shape[1]
    xa = x.to(adt)
    ys = []
    for p in st.parts:
        cols = (p.abs_windows()[:, :, None].long() * WINDOW
                + p.lidx_unpacked().long())
        inside = cols < n_cols
        xg = xa[torch.where(inside, cols, 0)] if n_cols else torch.zeros(
            cols.shape, dtype=adt, device=x.device)
        xg = torch.where(inside, xg, 0)
        ys.append(torch.sum(p.vals.to(adt) * xg, dim=1))     # (nb, 128)
    return _combine(st, ys)


# --- the kernel ----------------------------------------------------------------

def strip_kernel_bytes(st: StripELL) -> int:
    """Device-memory bytes one launch of the CUDA kernel must move: vals,
    the packed lidx, the first c_total wrel entries of each block, one wtile
    entry, block id and part index per block, x once and y once (in the
    dtype the kernel runs in).  The denominator of the kernel's GB/s."""
    adt = accum_dtype(st.dtype)
    total = 0
    for p in st.parts:
        nb, c_total, _ = p.vals.shape
        total += p.vals.numel() * adt.itemsize
        total += p.lidx.numel() * p.lidx.element_size()
        total += nb * c_total * 4 + nb * 3 * 4
    return int(total + (st.shape[1] + st.shape[0]) * adt.itemsize)


def _check_layout(st: StripELL) -> None:
    """Raise on a StripELL the kernel does not take: parts on several
    devices or packings, or arrays that do not form the layout."""
    dev = st.parts[0].vals.device
    if dev.type != "cuda" or any(t.device != dev for p in st.parts
                                 for t in (p.vals, p.lidx, p.wrel, p.wtile)):
        raise ValueError(f"strip_spmv: the kernel needs every part on one CUDA "
                         f"device, got {dev}")
    if st.dtype not in FLOAT_DTYPES:
        raise TypeError(f"strip_spmv: the CUDA kernel takes float values, got {st.dtype}")
    packs = {p.lidx_pack for p in st.parts}
    if len(packs) != 1:
        raise ValueError(f"strip_spmv: parts with lidx_pack {sorted(packs)}; "
                         f"one launch needs one packing")
    for p in st.parts:
        nb, c_total, rb = p.vals.shape
        cp = c_total // p.lidx_pack
        if (rb != RB or c_total % p.lidx_pack
                or tuple(p.lidx.shape) != (nb, cp, RB)
                or p.wrel.shape[0] != nb or p.wrel.shape[1] * WINDOW < c_total
                or p.wtile.shape[0] * p.g4 < nb or len(p.block_ids) != nb):
            raise ValueError("strip_spmv: a part's arrays do not form a StripELL "
                             "layout")
        if c_total > MAX_STRIPS:
            raise ValueError(f"strip_spmv: c_total {c_total} > {MAX_STRIPS}")
        if any(t.dtype != torch.int32 for t in (p.lidx, p.wrel, p.wtile)):
            raise TypeError("strip_spmv: lidx, wrel and wtile must be int32")
        if not all(t.is_contiguous() for t in (p.vals, p.lidx, p.wrel, p.wtile)):
            raise ValueError("strip_spmv: the kernel needs contiguous part arrays")


def _part_table(st: StripELL, vals) -> torch.Tensor:
    """(n_parts, 9) int64 device table: the pointers of each
    part's vals / lidx / wrel / wtile, then c_total, cp, cg·128 (the wrel
    row stride), g4 and the part's first block in the flat grid."""
    first = np.cumsum([0] + [p.n_blocks for p in st.parts])
    rows = [[v.data_ptr(), p.lidx.data_ptr(), p.wrel.data_ptr(),
             p.wtile.data_ptr(), p.c_total, p.c_total // p.lidx_pack,
             p.wrel.shape[1] * WINDOW, p.g4, int(f)]
            for p, v, f in zip(st.parts, vals, first)]
    return torch.tensor(rows, dtype=torch.int64).to(vals[0].device)


class _Plan:
    """What one launch needs besides x, built once per matrix after its
    layout is checked: the part table over the parts' own values, the part
    index and block id of every block of the flat grid, and the largest
    c_total (the shared-memory ints a block needs)."""

    def __init__(self, st: StripELL):
        _check_layout(st)
        dev = st.parts[0].vals.device
        part_of = np.concatenate([np.full(p.n_blocks, i, np.int32)
                                  for i, p in enumerate(st.parts)])
        ids = np.concatenate([np.asarray(p.block_ids, np.int64) for p in st.parts])
        self.part_of = torch.from_numpy(part_of).to(dev)
        self.block_ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        self.table = _part_table(st, [p.vals for p in st.parts])
        self.c_max = max(p.c_total for p in st.parts)
        self.pack = st.parts[0].lidx_pack


def _plan(st: StripELL) -> _Plan:
    """The matrix's launch plan, cached on it (a frozen matrix's layout and
    values never change)."""
    plan = st.__dict__.get("_strip_plan")
    if plan is None:
        plan = _Plan(st)
        object.__setattr__(st, "_strip_plan", plan)
    return plan


def strip_spmv(st: StripELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  CUDA: one launch of ``strip_spmv_kernel`` over every
    block of every part; CPU: the plain version."""
    if x.device.type == "cpu" and st.parts[0].vals.device.type == "cpu":
        return strip_spmv_ref(st, x)
    plan = _plan(st)
    if x.device != st.parts[0].vals.device:
        raise ValueError(f"strip_spmv: matrix on {st.parts[0].vals.device} and "
                         f"vector on {x.device}; the kernel needs both on one "
                         f"CUDA device")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"strip_spmv: the CUDA kernel takes a float vector, got {x.dtype}")
    if x.dim() != 1 or x.shape[0] != st.shape[1]:
        raise ValueError(f"strip_spmv: vector of shape {tuple(x.shape)} for a "
                         f"{st.shape} matrix")
    adt = accum_dtype(torch.promote_types(st.dtype, x.dtype))
    x = x.to(adt).contiguous()
    table = plan.table
    if adt != st.dtype:
        # values cast for this call: a table over the cast copies, which
        # the caching allocator keeps until the launch has run on this stream
        vals = [p.vals.to(adt) for p in st.parts]
        table = _part_table(st, vals)
    n_rows, n_cols = st.shape
    y = torch.empty(n_rows, dtype=adt, device=x.device)
    lib = _kernels()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"smt_strip_spmv_{_SUFFIX[adt]}")(
            table.data_ptr(), plan.part_of.data_ptr(), plan.block_ids.data_ptr(),
            int(plan.part_of.shape[0]), plan.pack, n_rows, n_cols,
            x.data_ptr(), y.data_ptr(), plan.c_max,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.smt_strip_error_string(rc).decode()
        raise RuntimeError(f"strip_spmv: CUDA error {rc} ({msg})")
    LAUNCHES["strip_spmv"] += 1
    return y
