"""StripELL SpMV and SpMM: the wrappers of the row-group kernels, the
SpMV's plain version and the launch counter (counterpart of
``sparsemat_tpu/kernels/strip.py``).

Neither product reads the padded layout: on a CUDA tensor the SpMV launches
``rowgroup_spmv_kernel`` (``csrc/spmv.cu``) and the SpMM
``rowgroup_spmm_kernel`` (``csrc/spmm.cu``; see the notes there for what
they replace and what bounds them) once per product over the matrix's
compact plan (``kernels/_rowgroup.py``), built once from ``to_coo`` (the
stored entries of every class part, padding gone) and cached on the matrix,
so the TPU's per-part launches, xᵀ tiles and ``_combine`` permutation have
no counterpart.  The SpMV's plain version keeps the per-part loop and
``_combine``, so the two are independent; the SpMM's is the JAX package's
path through CSR (``_common.spmm_through_csr``), with no kernel of its own.

Dtypes: the values and x or B are computed in the accumulation dtype of the
two (``accum_dtype(promote_types(...))``, so bf16/f16 in f32), as the JAX
wrapper casts them; the plan keeps each cast of its values.  One
difference from the plain versions: the kernels read no padding slot, so
where x or B holds inf or NaN at a column that only padding slots point
at, they give what a CSR product gives (scipy, ``torch.mv``,
``torch.sparse.mm``) and not the slot's 0·inf = NaN, which the plain SpMV
and ``strip_spmv_xla`` give; for a finite operand they agree.  A wrapper
takes its plain version only when its tensors lie on the CPU; on a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.strip import WINDOW, StripELL
from ..types import FLOAT_DTYPES, accum_dtype
from ..utils import profiling
from . import _rowgroup
from ._common import check_operand, spmm_through_csr

#: kernel launches (plain versions do not count)
LAUNCHES = profiling.register("kernels.strip", {"strip_spmv": 0, "strip_spmm": 0})


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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

def _check_layout(st: StripELL) -> None:
    """Every part's arrays on one CUDA device and float values: checked once
    per matrix, when its plan is built."""
    dev = st.parts[0].vals.device
    if dev.type != "cuda" or any(t.device != dev for p in st.parts
                                 for t in (p.vals, p.lidx, p.wrel, p.wtile, p.occ)):
        raise ValueError(f"strip kernels: the kernels need every part on one CUDA "
                         f"device, got {dev}")
    if st.dtype not in FLOAT_DTYPES:
        raise TypeError(f"strip kernels: the CUDA kernels take float values, got {st.dtype}")


def _on_cpu(st: StripELL, X: torch.Tensor) -> bool:
    return X.device.type == "cpu" and st.parts[0].vals.device.type == "cpu"


def strip_spmv(st: StripELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  CUDA: one launch of ``rowgroup_spmv_kernel`` over the
    plan of every class part; CPU: the plain version."""
    if _on_cpu(st, x):
        return strip_spmv_ref(st, x)
    check_operand(x, st.parts[0].vals.device, st.shape, "strip_spmv", (st.shape[1],))
    return _rowgroup.launch_spmv(_rowgroup.plan_of(st, _check_layout), x, LAUNCHES,
                                 "strip_spmv")


def strip_spmm(st: StripELL, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B for B (n_cols, m).  CUDA: one launch of
    ``rowgroup_spmm_kernel`` over the plan the SpMV walks; CPU: the plain path
    through CSR, a conversion a call.  The kernel skips the terms with no
    stored entry, which the padded layout's plain SpMV computes as 0·inf: for
    a B holding inf or NaN it gives what a CSR SpMM gives, as the plain path
    does."""
    if _on_cpu(st, B):
        return spmm_through_csr(st, B)
    check_operand(B, st.parts[0].vals.device, st.shape, "strip_spmm",
                  (st.shape[1], B.shape[-1]))
    return _rowgroup.launch(_rowgroup.plan_of(st, _check_layout), B, LAUNCHES, "strip_spmm")
