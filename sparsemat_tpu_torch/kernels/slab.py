"""SlabELL, SlabPack and SlabStream SpMV and SpMM: the CUDA kernels'
wrappers, their plain versions and launch counters.  Counterpart of
the slab halves of two JAX modules: ``sparsemat_tpu/kernels/spmv.py``
(``slab_spmv_pallas``, ``slab_pack_spmv_pallas``, ``slab_stream_spmv_pallas``
and their ``*_xla`` oracles) and ``sparsemat_tpu/kernels/spmm.py``
(``slab_spmm_pallas``, ``slab_pack_spmm_pallas``, ``slab_spmm_xla``); the
JAX package computes a SlabStream's SpMM through CSR, and so does its plain
version here (``_common.spmm_through_csr``).

The SpMV and SpMM do not read the padded layout: each launches a row-group
kernel (``csrc/spmv.cu`` and ``csrc/spmm.cu``, see the notes there for
what they replace and what bounds them) once per product over the
matrix's compact plan (``kernels/_rowgroup.py``), one plan shared by both,
which holds the stored entries of every part and of every overflow level,
or of every chunk of a SlabStream, so a SlabPack with an overflow pack is
one launch.  The TPU's per-part calls, its ``_slab_pack_combine``
permutation and the SlabStream's SMEM-sized splits, chunk groups and
resident y have no counterpart.  The plain versions keep the per-part loop,
the permutation and the chunk stream, so they and the kernels are
independent.

Dtypes: the values and x / B are cast to the accumulation dtype of the two
(bf16/f16 to f32) before the launch; the kernels run in f32 or f64.  One
difference of the row-group kernels from their plain versions: they read
no padding slot, so where x or B holds inf or NaN in a row that a padding
slot points at, they give what a CSR product gives (scipy, ``torch.mv``,
``torch.sparse.mm``) and not the slot's 0·inf = NaN, which the plain
versions and the ``*_xla`` oracles give; for a finite operand the two
agree.  A wrapper takes the plain version only when its tensors lie on the
CPU; on a CUDA tensor it launches its kernel or raises.  The layout is
checked once per matrix, when its plan is built, and the plan is cached on
it (``_rowgroup.plan_of``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.slab import WINDOW, SlabELL, SlabPack, SlabStream
from ..types import FLOAT_DTYPES, accum_dtype
from ..utils import profiling
from . import _rowgroup
from ._common import check_operand, gather, spmm_through_csr

#: kernel launches (plain versions do not count): one per product, any
#: number of overflow levels
LAUNCHES = profiling.register("kernels.slab", {"slab_spmv": 0, "slab_spmm": 0,
                                               "slab_stream_spmv": 0, "slab_stream_spmm": 0})

#: cap on the plain SpMM's materialised (slots, columns) gather of B
_REF_GATHER_BUDGET = 1 << 29


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    """Every SlabELL of a SlabELL or SlabPack, overflow levels included; a
    SlabStream is its own one part."""
    if not isinstance(mat, SlabPack):
        return [mat]
    return list(mat.parts) + (_parts(mat.overflow) if mat.overflow is not None else [])


def _check_layout(mat) -> None:
    """Every array of every part on one CUDA device and float values:
    checked once per matrix, when its plan is built."""
    dev = mat.data.device
    parts = _parts(mat)
    arrays = [getattr(p, f.name) for p in parts for f in dataclasses.fields(p)]
    if dev.type != "cuda" or any(t.device != dev for t in arrays
                                 if isinstance(t, torch.Tensor)):
        raise ValueError(f"slab kernels: the kernels need every part on one CUDA device, "
                         f"got {dev}")
    if any(p.vals.dtype not in FLOAT_DTYPES for p in parts):
        raise TypeError(f"slab kernels: the CUDA kernels take float values, got {mat.dtype}")


def _launch_spmv(mat, x: torch.Tensor, name: str = "slab_spmv",
                 launches: dict = LAUNCHES) -> torch.Tensor:
    """y = A @ x through ``rowgroup_spmv_kernel``, one launch per product,
    counted in ``launches[name]``."""
    check_operand(x, mat.data.device, mat.shape, name, (mat.shape[1],))
    return _rowgroup.launch_spmv(_rowgroup.plan_of(mat, _check_layout), x, launches, name)


def _launch_spmm(mat, B: torch.Tensor, name: str = "slab_spmm") -> torch.Tensor:
    """Y = A @ B through ``rowgroup_spmm_kernel``, one launch per product,
    counted in ``LAUNCHES[name]``."""
    check_operand(B, mat.data.device, mat.shape, name, (mat.shape[1], B.shape[-1]))
    return _rowgroup.launch(_rowgroup.plan_of(mat, _check_layout), B, LAUNCHES, name)


def _on_cpu(mat, X) -> bool:
    return mat.data.device.type == "cpu" and X.device.type == "cpu"


def slab_spmv(sl: SlabELL, x: torch.Tensor, launches: dict = LAUNCHES,
              name: str = "slab_spmv") -> torch.Tensor:
    """y = A @ x over a SlabELL.  CUDA: one launch of ``rowgroup_spmv_kernel``
    over the plan, counted in ``launches[name]``; CPU: the plain version."""
    return slab_spmv_ref(sl, x) if _on_cpu(sl, x) else _launch_spmv(sl, x, name, launches)


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


def slab_stream_spmv(st: SlabStream, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a SlabStream.  CUDA: one launch of
    ``rowgroup_spmv_kernel`` over the plan of its chunks; CPU: the plain
    version."""
    return slab_stream_spmv_ref(st, x) if _on_cpu(st, x) else _launch_spmv(
        st, x, "slab_stream_spmv")


def slab_stream_spmm(st: SlabStream, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B over a SlabStream, B (n_cols, m).  CUDA: one launch of
    ``rowgroup_spmm_kernel`` over the plan the SpMV walks; CPU: the plain path
    through CSR, a conversion a call.  The kernel skips the terms with no
    stored entry, which the padded layout's plain SpMV computes as 0·inf: for
    a B holding inf or NaN it gives what a CSR SpMM gives, as the plain path
    does."""
    return spmm_through_csr(st, B) if _on_cpu(st, B) else _launch_spmm(
        st, B, "slab_stream_spmm")
