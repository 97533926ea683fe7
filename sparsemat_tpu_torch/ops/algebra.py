"""Matrix algebra (counterpart of ``sparsemat_tpu/ops/algebra.py``).

Ported so far: the bilinear form ``inner_prod``.  SpGEMM, ``add``/``sub``,
``transpose`` and the structure predicates are not ported yet.
"""

from __future__ import annotations

import torch

from ..types import accum_dtype
from .matvec import spmv


def inner_prod(mat, l, r):
    """lᵀ A r: one ``spmv`` and a dot, summed in the accumulation dtype of
    l and A r (bf16/f16 in f32)."""
    y = spmv(mat, r)
    l = torch.as_tensor(l, device=y.device)
    adt = accum_dtype(torch.promote_types(l.dtype, y.dtype))
    return torch.dot(l.to(adt), y.to(adt))
