"""WELL SpMV and SpMM: the wrappers of the row-group kernels, the SpMV's
plain version and the launch counter (counterpart of the WELL half of
``sparsemat_tpu/kernels/spmv.py``: ``well_spmv_pallas`` and
``well_spmv_xla``).

Neither product reads the padded tiles: the SpMV is ``rowgroup_spmv_kernel``
(``csrc/spmv.cu``) and the SpMM ``rowgroup_spmm_kernel`` (``csrc/spmm.cu``;
see the notes there for what they replace and what bounds them), one
launch per product over the matrix's compact plan (``kernels/_rowgroup.py``),
built once from ``to_coo`` on the matrix's device and cached on it: the
stored entries only, tiles in any order, padding slots and tiles aimed past
the last row block dropped.  The TPU's ``chunks`` (one call per SMEM-sized
tile range) have no counterpart.  The SpMM's plain version is the JAX
package's path through CSR (``_common.spmm_through_csr``).

Dtypes: the values and x or B are computed in the accumulation dtype of the
two (bf16/f16 in f32); the kernels run in f32 or f64.  One difference from
the plain versions: the kernels read no padding slot, so where x or B holds
inf or NaN at a column a padding slot points at, they give what a CSR
product gives (scipy, ``torch.mv``, ``torch.sparse.mm``) and not the slot's
0·inf = NaN; for a finite operand they agree.  A wrapper takes its plain
version only when its tensors lie on the CPU; on a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

import torch

from ..formats.well import ROW_BLOCK, WELL, WINDOW
from ..types import FLOAT_DTYPES, accum_dtype
from ..utils import profiling
from . import _rowgroup
from ._common import check_operand, gather, spmm_through_csr

#: kernel launches (the plain version does not count)
LAUNCHES = profiling.register("kernels.well", {"well_spmv": 0, "well_spmm": 0})


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


# --- the kernels -----------------------------------------------------------------

def _check_layout(well: WELL) -> None:
    """The arrays on one CUDA device and float values: checked once per
    matrix, when its plan is built."""
    dev = well.vals.device
    if dev.type != "cuda" or any(t is not None and t.device != dev for t in
                                 (well.lidx, well.tile_rows, well.tile_wins, well.row_cnt)):
        raise ValueError(f"well kernels: the kernels need every array on one CUDA device, "
                         f"got {dev}")
    if well.vals.dtype not in FLOAT_DTYPES:
        raise TypeError(f"well kernels: the CUDA kernels take float values, got "
                        f"{well.vals.dtype}")


def _on_cpu(well: WELL, X: torch.Tensor) -> bool:
    return well.vals.device.type == "cpu" and X.device.type == "cpu"


def well_spmv(well: WELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a WELL.  CUDA: one launch of ``rowgroup_spmv_kernel``
    over the plan; CPU: the plain version."""
    if _on_cpu(well, x):
        return well_spmv_ref(well, x)
    check_operand(x, well.vals.device, well.shape, "well_spmv", (well.shape[1],))
    return _rowgroup.launch_spmv(_rowgroup.plan_of(well, _check_layout), x, LAUNCHES,
                                 "well_spmv")


def well_spmm(well: WELL, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B over a WELL, B (n_cols, m).  CUDA: one launch of
    ``rowgroup_spmm_kernel`` over the plan the SpMV walks; CPU: the plain path
    through CSR, a conversion a call.  The kernel skips the terms with no
    stored entry, which the padded layout's plain SpMV computes as 0·inf: for
    a B holding inf or NaN it gives what a CSR SpMM gives, as the plain path
    does."""
    if _on_cpu(well, B):
        return spmm_through_csr(well, B)
    check_operand(B, well.vals.device, well.shape, "well_spmm", (well.shape[1], B.shape[-1]))
    return _rowgroup.launch(_rowgroup.plan_of(well, _check_layout), B, LAUNCHES, "well_spmm")
