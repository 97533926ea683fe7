"""WELL SpMV's plain version (counterpart of the WELL half of
``sparsemat_tpu/kernels/spmv.py``: ``well_spmv_pallas`` and
``well_spmv_xla``).

Neither product reads the padded tiles on a card: ``ops/matvec.py``
launches ``rowgroup_spmv_kernel`` (``csrc/spmv.cu``) or
``rowgroup_spmm_kernel`` (``csrc/spmm.cu``; see the notes there for what
they replace and what bounds them) once per product over the matrix's
compact plan (``kernels/_rowgroup.py``), built once from ``to_coo`` on the
matrix's device and cached on it: the stored entries only, tiles in any
order, padding slots and tiles aimed past the last row block dropped.  The
TPU's ``chunks`` (one call per SMEM-sized tile range) have no counterpart.
The SpMM's plain version is the JAX package's path through CSR.

Dtypes: the values and x are computed in the accumulation dtype of the two
(bf16/f16 in f32).  One difference from the kernels: they read no padding
slot, so where x holds inf or NaN at a column a padding slot points at,
they give what a CSR product gives (scipy, ``torch.mv``) and not the
slot's 0·inf = NaN; for a finite operand they agree.
"""

from __future__ import annotations

import torch

from ..formats.well import ROW_BLOCK, WELL, WINDOW
from ..types import accum_dtype
from ._common import gather


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
