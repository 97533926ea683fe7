"""COO (coordinate) format — the frozen snapshot of the assembly phase
(counterpart of ``sparsemat_tpu/formats/coo.py``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..types import DEFAULT_INDEX_DTYPE, as_torch_dtype, resolve_device
from .base import SparseFormat, dedup_sorted_coo, rows_to_indptr, sort_coo, to_device


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class COO(SparseFormat):
    """Frozen coordinate-format sparse matrix.

    ``rows``/``cols``/``vals`` are parallel 1-D tensors of length ``nse``;
    entries with ``row == n_rows`` are tail padding.  ``canonical=True``
    promises row-major column-sorted deduplicated order with padding at the
    tail.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: Tuple[int, int]
    canonical: bool = False

    @classmethod
    def from_arrays(cls, rows, cols, vals, shape=None, *,
                    index_dtype=DEFAULT_INDEX_DTYPE, canonical=False, device=None):
        """From parallel arrays.  Tensors stay on their device unless
        ``device`` names another; host (numpy) inputs go to ``device``
        (None: the current CUDA card)."""
        if device is None and not isinstance(rows, torch.Tensor):
            device = resolve_device(None)
        rows = torch.as_tensor(rows, device=device)
        cols = torch.as_tensor(cols, device=device)
        vals = torch.as_tensor(vals, device=device)
        if rows.is_floating_point():
            rows = rows.to(as_torch_dtype(index_dtype))
            cols = cols.to(as_torch_dtype(index_dtype))
        if shape is None:
            # grow-from-touched-coordinates: shape = (max row+1, max col+1)
            shape = (int(rows.max()) + 1 if rows.numel() else 0,
                     int(cols.max()) + 1 if cols.numel() else 0)
        return cls(rows=rows, cols=cols, vals=vals,
                   shape=tuple(int(s) for s in shape), canonical=canonical)

    @classmethod
    def from_dense(cls, mat, *, index_dtype=DEFAULT_INDEX_DTYPE, device=None):
        mat = np.asarray(mat)
        device = resolve_device(device)
        r, c = np.nonzero(mat)
        return cls(rows=to_device(r, index_dtype, device),
                   cols=to_device(c, index_dtype, device),
                   vals=to_device(mat[r, c], None, device),
                   shape=tuple(mat.shape), canonical=True)

    @classmethod
    def eye(cls, dim: int, *, dtype=torch.float32,
            index_dtype=DEFAULT_INDEX_DTYPE, device=None):
        device = resolve_device(device)
        idx = torch.arange(dim, dtype=as_torch_dtype(index_dtype), device=device)
        return cls(rows=idx, cols=idx,
                   vals=torch.ones(dim, dtype=as_torch_dtype(dtype), device=device),
                   shape=(dim, dim), canonical=True)

    # -- canonical views ------------------------------------------------------
    def to_coo(self) -> "COO":
        return self

    def to_csr(self):
        from .csr import CSR

        return CSR.from_coo(self)

    def to_ell(self, n_cols_per_row: int | None = None):
        from .ell import ELL

        return ELL.from_coo(self, n_cols_per_row=n_cols_per_row)

    def sort(self) -> "COO":
        """Canonicalize: sort row-major/column-sorted and sum duplicates."""
        if self.canonical:
            return self
        r, c, v = sort_coo(self.rows, self.cols, self.vals, self.shape)
        r, c, v, _ = dedup_sorted_coo(r, c, v, self.shape)
        return COO(rows=r, cols=c, vals=v, shape=self.shape, canonical=True)

    # -- structure ----------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.rows.shape[0])

    @property
    def index_dtype(self):
        return self.rows.dtype

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self) -> int:
        return int((self.rows.long() < self.n_rows).sum())

    def indptr(self):
        """Row offsets of the canonical order (requires canonical=True)."""
        return rows_to_indptr(self.rows, self.n_rows, self.index_dtype)

    def scale(self, scalar) -> "COO":
        return dataclasses.replace(self, vals=self.vals * scalar)

    def prune(self, keep_zeros: bool = True) -> "COO":
        """The entries without tail padding (and, with ``keep_zeros=False``,
        without stored zeros), on the same device."""
        keep = self.rows.long() < self.n_rows
        if not keep_zeros:
            keep &= self.vals != 0
        return COO(rows=self.rows[keep], cols=self.cols[keep], vals=self.vals[keep],
                   shape=self.shape, canonical=self.canonical)

    def with_padding_to(self, nse: int) -> "COO":
        """The same entries with tail padding up to ``nse`` slots."""
        extra = nse - self.nse
        if extra < 0:
            raise ValueError(f"cannot shrink from {self.nse} to {nse}; use prune()")
        if extra == 0:
            return self
        r = self.rows
        return COO(rows=torch.cat([r, r.new_full((extra,), self.n_rows)]),
                   cols=torch.cat([self.cols, self.cols.new_zeros(extra)]),
                   vals=torch.cat([self.vals, self.vals.new_zeros(extra)]),
                   shape=self.shape, canonical=self.canonical)
