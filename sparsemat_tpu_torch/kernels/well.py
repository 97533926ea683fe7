"""WELL SpMV: the CUDA kernel's wrapper, its plain version and launch
counter (counterpart of the WELL half of ``sparsemat_tpu/kernels/spmv.py``:
``well_spmv_pallas`` and ``well_spmv_xla``).

The kernel does not read the padded tiles: it is the row-group SpMV
(``csrc/spmv.cu``, see the note there for what it replaces and what bounds
it), one launch per product over the matrix's compact plan
(``kernels/_rowgroup.py``), built once from ``to_coo`` on the matrix's
device and cached on it: the stored entries only, tiles in any order,
padding slots and tiles aimed past the last row block dropped.  The TPU's
``chunks`` (one call per SMEM-sized tile range) have no counterpart.

Dtypes: the values and x are computed in the accumulation dtype of the two
(bf16/f16 in f32); the kernel runs in f32 or f64.  One difference from the
plain version: the kernel reads no padding slot, so where x holds inf or
NaN at a column a padding slot points at, it gives what a CSR SpMV gives
(scipy, ``torch.mv``) and not the slot's 0·inf = NaN; for a finite x the
two agree.  The wrapper takes the plain version only when its tensors lie
on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..formats.well import ROW_BLOCK, WELL, WINDOW
from ..types import FLOAT_DTYPES, accum_dtype
from ..utils import profiling
from . import _rowgroup
from ._common import gather

#: kernel launches (the plain version does not count)
LAUNCHES = profiling.register("kernels.well", {"well_spmv": 0})


def reset_launches() -> None:
    LAUNCHES["well_spmv"] = 0


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

def _check_layout(well: WELL) -> None:
    """The arrays on one CUDA device and float values: checked once per
    matrix, when its plan is built."""
    dev = well.vals.device
    if dev.type != "cuda" or any(t is not None and t.device != dev for t in
                                 (well.lidx, well.tile_rows, well.tile_wins, well.row_cnt)):
        raise ValueError(f"well_spmv: the kernel needs every array on one CUDA device, "
                         f"got {dev}")
    if well.vals.dtype not in FLOAT_DTYPES:
        raise TypeError(f"well_spmv: the CUDA kernel takes float values, got {well.vals.dtype}")


def well_spmv(well: WELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over a WELL.  CUDA: one launch of ``rowgroup_spmv_kernel``
    over the plan; CPU: the plain version."""
    if well.vals.device.type == "cpu" and x.device.type == "cpu":
        return well_spmv_ref(well, x)
    if x.device != well.vals.device:
        raise ValueError(f"well_spmv: matrix on {well.vals.device} and vector on {x.device}; "
                         f"the kernel needs both on one CUDA device")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"well_spmv: the CUDA kernel takes a float vector, got {x.dtype}")
    if x.dim() != 1 or x.shape[0] != well.shape[1]:
        raise ValueError(f"well_spmv: vector of shape {tuple(x.shape)} for a "
                         f"{well.shape} matrix")
    return _rowgroup.launch_spmv(_rowgroup.plan_of(well, _check_layout), x, LAUNCHES,
                                 "well_spmv")
