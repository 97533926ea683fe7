"""SlabELL, SlabPack and SlabStream products' plain versions.  Counterpart
of the slab halves of two JAX modules: ``sparsemat_tpu/kernels/spmv.py``
(``slab_spmv_pallas``, ``slab_pack_spmv_pallas``, ``slab_stream_spmv_pallas``
and their ``*_xla`` oracles) and ``sparsemat_tpu/kernels/spmm.py``
(``slab_spmm_pallas``, ``slab_pack_spmm_pallas``, ``slab_spmm_xla``); the
JAX package computes a SlabStream's SpMM through CSR, and so does its plain
version here.

On a card the SpMV and SpMM do not read the padded layout:
``ops/matvec.py`` launches a row-group kernel (``csrc/spmv.cu`` and
``csrc/spmm.cu``, see the notes there for what they replace and what
bounds them) once per product over the matrix's compact plan
(``kernels/_rowgroup.py``), one plan shared by both, which holds the stored
entries of every part and of every overflow level, or of every chunk of a
SlabStream, so a SlabPack with an overflow pack is one launch.  The TPU's
per-part calls, its ``_slab_pack_combine`` permutation and the
SlabStream's SMEM-sized splits, chunk groups and resident y have no
counterpart.  The plain versions keep the per-part loop, the permutation
and the chunk stream, so they and the kernels are independent.

Dtypes: the values and x / B are cast to the accumulation dtype of the two
(bf16/f16 to f32).  One difference of the row-group kernels from these
plain versions: they read no padding slot, so where x or B holds inf or
NaN in a row that a padding slot points at, they give what a CSR product
gives (scipy, ``torch.mv``, ``torch.sparse.mm``) and not the slot's 0·inf
= NaN, which the plain versions and the ``*_xla`` oracles give; for a
finite operand the two agree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.slab import WINDOW, SlabELL, SlabPack, SlabStream
from ..types import accum_dtype
from ._common import gather

#: cap on the plain SpMM's materialised (slots, columns) gather of B
_REF_GATHER_BUDGET = 1 << 29


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
