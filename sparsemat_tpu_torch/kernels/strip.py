"""StripELL SpMV's plain version (counterpart of
``sparsemat_tpu/kernels/strip.py``).

Neither product reads the padded layout on a card: ``ops/matvec.py``
launches ``rowgroup_spmv_kernel`` (``csrc/spmv.cu``) or
``rowgroup_spmm_kernel`` (``csrc/spmm.cu``; see the notes there for what
they replace and what bounds them) once per product over the matrix's
compact plan (``kernels/_rowgroup.py``), built once from ``to_coo`` (the
stored entries of every class part, padding gone) and cached on the matrix,
so the TPU's per-part launches, xᵀ tiles and ``_combine`` permutation have
no counterpart.  The SpMV's plain version here keeps the per-part loop and
``_combine``, so the two are independent; the SpMM's is the JAX package's
path through CSR, with no kernel of its own.

Dtypes: the values and x are computed in the accumulation dtype of the two
(``accum_dtype(promote_types(...))``, so bf16/f16 in f32), as the JAX
wrapper casts them.  One difference from the kernels: they read no padding
slot, so where x holds inf or NaN at a column that only padding slots
point at, they give what a CSR product gives (scipy, ``torch.mv``) and not
the slot's 0·inf = NaN, which the plain SpMV and ``strip_spmv_xla`` give;
for a finite operand they agree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.strip import WINDOW, StripELL
from ..types import accum_dtype


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
