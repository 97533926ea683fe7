"""BSR SpMM: the wrapper of the row-group CUDA kernel, its plain version and
launch counter (counterpart of the BSR half of
``sparsemat_tpu/kernels/spmm.py``; the slab SpMM is in ``kernels/slab.py``).

Y = A @ B with A a BSR and B dense (n_cols, m).  On a CUDA tensor the
wrapper launches ``rowgroup_spmm_kernel`` (``csrc/spmm.cu``, see the note
there for what it replaces and what bounds it) over the matrix's compact
launch plan (``kernels/_rowgroup.py``): the stored entries only, built once
per matrix on its device from the blocks (``occ`` where the freeze made
one, nonzero values where it did not, ``_rowgroup.bsr_entries``), cached
on the matrix.  The zero
slots of the blocks are not read, so the TPU's per-block MXU products, its
first-visit zeroing and its chunked calls have no counterpart.  The plain
version is the JAX package's ``bsr_spmm_xla``: a batched product of every
block with its slice of B, then a segment sum over each block row's tiles.

Dtypes: bf16/f16 blocks and B are computed in f32, f32 and f64 natively,
with plain FMAs (no TF32), as the TPU kernel runs at
``Precision.HIGHEST``.  One difference from the plain version: the kernel
skips the zeros of a block that are not stored entries, so where B holds
inf or NaN in a row that such a zero meets, it gives what a CSR SpMM gives
(scipy, ``torch.sparse.mm``) and not the dense block's 0·inf = NaN; for a
finite B the two agree.  The wrapper takes the plain version only when its
tensors lie on the CPU; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats.bsr import BSR
from ..types import FLOAT_DTYPES, accum_dtype
from ..utils import profiling
from . import _rowgroup

#: kernel launches (plain versions do not count)
LAUNCHES = profiling.register("kernels.spmm", {"bsr_spmm": 0})


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _adt(bsr: BSR, B: torch.Tensor) -> torch.dtype:
    return accum_dtype(torch.promote_types(bsr.blocks.dtype, B.dtype))


# --- plain version -------------------------------------------------------------

def bsr_spmm_ref(bsr: BSR, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B: each block times the ``bc`` rows of B at its block column
    (rows past n_cols and block columns past the end read 0), a batched
    product in the accumulation dtype, then each block row's tiles summed
    in tile order (a segment sum over the stably sorted block rows, no
    atomics).  On a card the product runs in full f32 when TF32 is off
    (``torch.backends.cuda.matmul.allow_tf32``, False by default)."""
    n_rows, _ = bsr.shape
    t, br, bc = bsr.blocks.shape
    m = B.shape[1]
    adt = _adt(bsr, B)
    if m == 0 or t == 0:
        return torch.zeros((n_rows, m), dtype=adt, device=B.device)
    n_rb = -(-n_rows // br)
    Bp = F.pad(B.to(adt), (0, 0, 0, -B.shape[0] % bc))
    kb = Bp.shape[0] // bc
    Bb = Bp.reshape(kb, bc, m)
    bcols = bsr.block_cols.long()
    inside = (bcols >= 0) & (bcols < kb)
    gathered = Bb[torch.where(inside, bcols, 0)] if kb else Bb.new_zeros((t, bc, m))
    gathered = torch.where(inside[:, None, None], gathered, 0)
    partial = torch.bmm(bsr.blocks.to(adt), gathered)                    # (T, br, m)
    brows = bsr.block_rows.long()
    keep = (brows >= 0) & (brows < n_rb)
    order = torch.sort(torch.where(keep, brows, n_rb), stable=True).indices
    counts = torch.bincount(brows[keep], minlength=n_rb)
    Y = torch.segment_reduce(partial[order[: int(counts.sum())]], "sum",
                             lengths=counts, axis=0, unsafe=True)
    return Y.reshape(-1, m)[:n_rows]


# --- the kernel ----------------------------------------------------------------

def bsr_spmm(bsr: BSR, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B.  CUDA: one launch of ``rowgroup_spmm_kernel`` over the
    plan; CPU: the plain version."""
    n_rows, n_cols = bsr.shape
    if B.dim() != 2 or B.shape[0] != n_cols:
        raise ValueError(f"bsr_spmm: B of shape {tuple(B.shape)} for a {bsr.shape} matrix")
    if bsr.blocks.device.type == "cpu" and B.device.type == "cpu":
        return bsr_spmm_ref(bsr, B)
    if B.device != bsr.blocks.device:
        raise ValueError(f"bsr_spmm: matrix on {bsr.blocks.device} and B on {B.device}; "
                         f"the kernel needs both on one CUDA device")
    if B.dtype not in FLOAT_DTYPES:
        raise TypeError(f"bsr_spmm: the CUDA kernel takes a float B, got {B.dtype}")
    if bsr.blocks.device.type != "cuda" or any(
            t is not None and t.device != bsr.blocks.device
            for t in (bsr.block_rows, bsr.block_cols, bsr.occ)):
        raise ValueError(f"bsr_spmm: the kernel needs blocks, block_rows, block_cols and occ "
                         f"on one CUDA device, got {bsr.blocks.device}")
    if bsr.blocks.dtype not in FLOAT_DTYPES:
        raise TypeError(f"bsr_spmm: the CUDA kernel takes float blocks, got "
                        f"{bsr.blocks.dtype}")
    return _rowgroup.launch(_rowgroup.plan_of(bsr), B, LAUNCHES, "bsr_spmm")


def spmm_pallas(mat, B: torch.Tensor) -> torch.Tensor:
    """Dispatch entry for ``ops.spmm(method='pallas')`` (the JAX package's
    name): a BSR as it is, any other format frozen to BSR first."""
    bsr = mat if isinstance(mat, BSR) else BSR.from_csr(mat.to_csr())
    return bsr_spmm(bsr, B)
