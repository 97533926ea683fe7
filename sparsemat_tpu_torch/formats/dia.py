"""DIA (diagonal) format for banded and stencil matrices (counterpart of
``sparsemat_tpu/formats/dia.py``).

    y[i] = Σ_d  data[d, i] · x[i + offset_d]

``data`` is row-major (n_diags, n_rows), which is the layout the CUDA kernel
streams with coalesced reads.  The JAX package's lane-packed ``tdata`` copy
exists for the TPU's (8, 128) tiling and has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..types import accum_dtype
from .base import SparseFormat, to_device


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class DIA(SparseFormat):
    """Frozen diagonal-format matrix.

    ``offsets``: tuple of diagonal offsets (col - row), ascending;
    ``data``: (n_diags, n_rows) — ``data[d, i] = A[i, i + offsets[d]]``
    (slots outside the matrix are 0).
    """

    data: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    def __post_init__(self):
        # the kernels read the offsets from device memory: upload them once
        object.__setattr__(self, "offsets_dev", torch.tensor(
            self.offsets, dtype=torch.int64).to(self.data.device))

    @classmethod
    def from_csr(cls, csr) -> "DIA":
        """Host-side freeze: every distinct (col - row) offset becomes a
        diagonal."""
        n_rows = csr.shape[0]
        rows = csr.host("row_ids")
        cols = csr.host("indices")
        vals = csr.host("data")
        valid = rows < n_rows
        rows, cols, vals = rows[valid], cols[valid], vals[valid]
        diff = cols.astype(np.int64) - rows.astype(np.int64)
        offs = np.unique(diff)
        data = np.zeros((len(offs), n_rows), vals.dtype)
        data[np.searchsorted(offs, diff), rows] = vals
        return cls(data=to_device(data, csr.dtype, csr.device),
                   offsets=tuple(int(o) for o in offs), shape=tuple(csr.shape))

    @staticmethod
    def diagonal_count(csr) -> int:
        """Number of distinct nonzero diagonals (host-side dispatch metric)."""
        rows = csr.host("row_ids")
        cols = csr.host("indices")
        valid = rows < csr.shape[0]
        return int(np.unique(cols[valid].astype(np.int64)
                             - rows[valid].astype(np.int64)).size)

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows, n_cols = self.shape
        nd = len(self.offsets)
        dev = self.data.device
        i = torch.arange(n_rows, dtype=torch.int32, device=dev).expand(nd, n_rows)
        j = i + self.offsets_dev.to(torch.int32)[:, None]
        in_range = (j >= 0) & (j < n_cols)
        # a stored zero is indistinguishable from absence in DIA (like
        # scipy.sparse.dia_matrix), so zeros count as padding
        stored = in_range & (self.data != 0)
        rows = torch.where(stored, i, n_rows).reshape(-1)
        cols = torch.where(stored, j, 0).reshape(-1)
        vals = torch.where(stored, self.data, torch.zeros_like(self.data)).reshape(-1)
        return COO(rows=rows, cols=cols, vals=vals, shape=self.shape,
                   canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    def to_dia(self) -> "DIA":
        return self

    # -- structure ----------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    @property
    def index_dtype(self):
        return torch.int32

    def n_non_zero_entries(self) -> int:
        return int(torch.count_nonzero(self.data))

    def scale(self, scalar) -> "DIA":
        return dataclasses.replace(self, data=self.data * scalar)

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return torch.zeros(self.n_rows, dtype=self.data.dtype, device=self.data.device)


def _pad_extents(dia: DIA):
    n_rows, n_cols = dia.shape
    lo = max(0, -min(dia.offsets)) if dia.offsets else 0
    hi = max(0, max(dia.offsets) + n_rows - n_cols) if dia.offsets else 0
    return lo, hi


def dia_spmv(dia: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x as Σ_d data[d] · x_pad[d+L : d+L+n] — shifted slices of a
    zero-padded x, summed in diagonal order.  data is zero outside the valid
    band, so no masking is needed.  The plain version of the DIA kernel."""
    n_rows = dia.shape[0]
    adt = accum_dtype(torch.promote_types(dia.data.dtype, x.dtype))
    L, R = _pad_extents(dia)
    xp = F.pad(x.to(adt), (L, R))
    y = torch.zeros(n_rows, dtype=adt, device=x.device)
    for d, off in enumerate(dia.offsets):
        start = off + L
        y = y + dia.data[d].to(adt) * xp[start:start + n_rows]
    return y


def dia_spmm(dia: DIA, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B for dense B — same padded shifted-slice formulation."""
    n_rows = dia.shape[0]
    adt = accum_dtype(torch.promote_types(dia.data.dtype, B.dtype))
    L, R = _pad_extents(dia)
    Bp = F.pad(B.to(adt), (0, 0, L, R))
    y = torch.zeros((n_rows, B.shape[1]), dtype=adt, device=B.device)
    for d, off in enumerate(dia.offsets):
        start = off + L
        y = y + dia.data[d].to(adt)[:, None] * Bp[start:start + n_rows]
    return y
