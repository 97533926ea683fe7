"""BSR SpMM's plain version (counterpart of the BSR half of
``sparsemat_tpu/kernels/spmm.py``; the slab SpMM's is in
``kernels/slab.py``).

Y = A @ B with A a BSR and B dense (n_cols, m).  On a card
``ops/matvec.py`` launches ``rowgroup_spmm_kernel`` (``csrc/spmm.cu``, see
the note there for what it replaces and what bounds it) over the matrix's
compact launch plan (``kernels/_rowgroup.py``): the stored entries only,
built once per matrix on its device from the blocks (``occ`` where the
freeze made one, nonzero values where it did not,
``_rowgroup.bsr_entries``), cached on the matrix.  The zero slots of the
blocks are not read, so the TPU's per-block MXU products, its first-visit
zeroing and its chunked calls have no counterpart.  The plain version here
is the JAX package's ``bsr_spmm_xla``: a batched product of every block
with its slice of B, then a segment sum over each block row's tiles.

Dtypes: bf16/f16 blocks and B are computed in f32, f32 and f64 natively,
with plain FMAs (no TF32), as the TPU kernel runs at
``Precision.HIGHEST``.  One difference from the kernel: it skips the zeros
of a block that are not stored entries, so where B holds inf or NaN in a
row that such a zero meets, it gives what a CSR SpMM gives (scipy,
``torch.sparse.mm``) and not the dense block's 0·inf = NaN; for a finite B
the two agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..formats.bsr import BSR
from ..types import accum_dtype


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
    adt = accum_dtype(torch.promote_types(bsr.blocks.dtype, B.dtype))
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
