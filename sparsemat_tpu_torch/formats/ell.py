"""ELL (ELLPACK) — every row padded to K slots (counterpart of
``sparsemat_tpu/formats/ell.py``).

SpMV and SpMM over it are K dense gather-multiply sweeps with static
shapes.  Rows are padded with (col = 0, val = 0), which is gather-safe and
adds nothing.  The freeze runs on the CSR's own tensors, so the arrays are
the JAX package's: a slot (i, j) takes CSR entry ``indptr[i] + j`` when
``j < row_nnz[i]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .base import SparseFormat


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class ELL(SparseFormat):
    """Frozen ELLPACK matrix.

    ``cols``: (n_rows_padded, K) column id per slot (padding 0);
    ``vals``: (n_rows_padded, K) value per slot (padding 0);
    ``row_nnz``: (n_rows_padded,) valid slots per row.
    ``n_rows_padded`` is n_rows rounded up to ``ROW_PAD``.
    """

    _spmv_read_fields = ("cols", "vals")  # row_nnz is freeze-time bookkeeping

    cols: torch.Tensor
    vals: torch.Tensor
    row_nnz: torch.Tensor
    shape: Tuple[int, int]

    ROW_PAD = 8  # the JAX package's f32 sublane count, kept for equal arrays

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_csr(cls, csr, n_cols_per_row: int | None = None) -> "ELL":
        """Freeze a CSR matrix into ELL; K is the longest row (at least 1)
        unless ``n_cols_per_row`` is given (longer rows are then cut, as in
        the JAX package)."""
        if n_cols_per_row is None:
            n_cols_per_row = max(csr.max_row_nnz(), 1)
        k = int(n_cols_per_row)
        n_rows, _ = csr.shape
        n_rows_p = -(-n_rows // cls.ROW_PAD) * cls.ROW_PAD
        dev = csr.indices.device
        nse = csr.nse
        row_nnz = csr.row_nnz()
        j = torch.arange(k, device=dev)
        src = csr.indptr[:-1].long()[:, None] + j[None, :]
        valid = j[None, :] < row_nnz.long()[:, None]
        src = torch.where(valid, src, nse)          # one past the end reads 0
        ind = torch.cat([csr.indices, csr.indices.new_zeros(1)])
        dat = torch.cat([csr.data, csr.data.new_zeros(1)])
        cols = torch.where(valid, ind[src], 0).to(csr.indices.dtype)
        vals = torch.where(valid, dat[src], 0).to(csr.data.dtype)
        pad_r = n_rows_p - n_rows
        if pad_r:
            cols = torch.cat([cols, cols.new_zeros((pad_r, k))])
            vals = torch.cat([vals, vals.new_zeros((pad_r, k))])
            row_nnz = torch.cat([row_nnz, row_nnz.new_zeros(pad_r)])
        return cls(cols=cols, vals=vals, row_nnz=row_nnz, shape=tuple(csr.shape))

    @classmethod
    def from_coo(cls, coo, n_cols_per_row: int | None = None) -> "ELL":
        from .csr import CSR

        return cls.from_csr(CSR.from_coo(coo), n_cols_per_row=n_cols_per_row)

    # -- canonical views ----------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows = self.shape[0]
        n_rows_p, k = self.cols.shape
        dev = self.cols.device
        r = torch.arange(n_rows_p, dtype=torch.int32, device=dev)[:, None].expand(n_rows_p, k)
        valid = ((torch.arange(k, dtype=torch.int32, device=dev)[None, :]
                  < self.row_nnz[:, None].to(torch.int32)) & (r < n_rows))
        return COO(rows=torch.where(valid, r, n_rows).reshape(-1).to(self.cols.dtype),
                   cols=torch.where(valid, self.cols, 0).reshape(-1),
                   vals=torch.where(valid, self.vals, 0).reshape(-1),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        from .csr import CSR

        return CSR.from_coo(self.to_coo().sort())

    def to_ell(self, n_cols_per_row: int | None = None) -> "ELL":
        return self

    # -- structure ----------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.cols.shape[0] * self.cols.shape[1])

    @property
    def n_cols_per_row(self) -> int:
        return int(self.cols.shape[1])

    @property
    def index_dtype(self):
        return self.cols.dtype

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self) -> int:
        return int(self.row_nnz[: self.n_rows].sum())

    def scale(self, scalar) -> "ELL":
        return dataclasses.replace(self, vals=self.vals * scalar)

    def fill_ratio(self) -> float:
        return self.n_non_zero_entries() / max(self.nse, 1)
