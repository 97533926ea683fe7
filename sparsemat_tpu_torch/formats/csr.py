"""CSR — the canonical frozen compute format (counterpart of
``sparsemat_tpu/formats/csr.py``).

Rows are always column-sorted.  ``row_ids`` (the expanded per-entry row
index) is computed at freeze time, as in the JAX package, so the two
packages' frozen arrays can be compared one to one.  Row and column access
(``get_row``, ``iter_row``, ``iter_col``) runs on the host through the
host-array cache.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..types import DEFAULT_INDEX_DTYPE, as_torch_dtype, host_dtype, resolve_device
from .base import SparseFormat, indptr_to_rows, to_device


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class CSR(SparseFormat):
    """Frozen compressed-sparse-row matrix.

    ``indptr``: (n_rows+1,) row offsets over the *valid* entries;
    ``indices``: (nse,) column ids (tail padding = 0);
    ``data``: (nse,) values (tail padding = 0);
    ``row_ids``: (nse,) expanded row per entry (tail padding = n_rows).
    """

    _spmv_read_fields = ("data", "indices", "row_ids")  # the stream path skips indptr

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    row_ids: torch.Tensor
    shape: Tuple[int, int]

    # -- constructors -----------------------------------------------------------
    @classmethod
    def from_coo(cls, coo) -> "CSR":
        coo = coo.sort()
        return cls(indptr=coo.indptr(), indices=coo.cols, data=coo.vals,
                   row_ids=coo.rows, shape=coo.shape)

    @classmethod
    def from_arrays(cls, indptr, indices, data, shape, *, device=None) -> "CSR":
        """From CSR arrays.  Host (numpy) inputs are checked and expanded on
        the host and uploaded once to ``device`` (None: the current CUDA
        card); tensors are taken as they are."""
        if isinstance(indptr, torch.Tensor):
            return cls(indptr=indptr, indices=indices, data=data,
                       row_ids=indptr_to_rows(indptr, indices.shape[0]),
                       shape=tuple(shape))
        device = resolve_device(device)
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        data = np.asarray(data)
        ip = indptr.astype(np.int64)
        if ip.shape[0] != int(shape[0]) + 1 or ip[0] != 0 or np.any(np.diff(ip) < 0) \
                or ip[-1] > indices.shape[0] or indices.shape != data.shape:
            raise ValueError("malformed CSR arrays (indptr must start at 0, be "
                             "non-decreasing, and end within indices/data)")
        n_rows = ip.shape[0] - 1
        rid = np.full(indices.shape[0], n_rows, np.int64)
        rid[: ip[-1]] = np.repeat(np.arange(n_rows), np.diff(ip))
        rid = rid.astype(indptr.dtype)
        out = cls(indptr=to_device(indptr, None, device),
                  indices=to_device(indices, None, device),
                  data=to_device(data, None, device),
                  row_ids=to_device(rid, None, device), shape=tuple(shape))
        return out._stash_host(indptr=indptr, indices=indices, data=data,
                               row_ids=rid)

    @classmethod
    def from_host_coo(cls, rows, cols, vals, shape, *, dtype=None,
                      index_dtype=DEFAULT_INDEX_DTYPE, sum_duplicates=True,
                      device=None) -> "CSR":
        """Canonical CSR from host (numpy) triplets, built entirely on the
        host and uploaded once to ``device`` (None: the current CUDA card) —
        the builder's and loaders' freeze path."""
        device = resolve_device(device)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if rows.dtype.kind not in "iu":
            rows = rows.astype(np.int64)
        if cols.dtype.kind not in "iu":
            cols = cols.astype(np.int64)
        vals = np.asarray(vals)
        tdt = as_torch_dtype(dtype if dtype is not None else vals.dtype)
        if vals.dtype != host_dtype(tdt):
            vals = vals.astype(host_dtype(tdt))
        n_rows, n_cols = map(int, shape)
        # already canonical (strictly ascending (row, col))? skip the
        # lexsort and the dedup pass
        if rows.size and np.all(
                (rows[1:] > rows[:-1])
                | ((rows[1:] == rows[:-1]) & (cols[1:] > cols[:-1]))):
            sum_duplicates = False
        else:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            key_new = np.empty(rows.size, bool)
            key_new[0] = True
            key_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            gid = np.cumsum(key_new) - 1
            summed = np.zeros(int(gid[-1]) + 1, vals.dtype)
            np.add.at(summed, gid, vals)
            rows, cols, vals = rows[key_new], cols[key_new], summed
        idt = host_dtype(index_dtype)
        counts = np.bincount(rows, minlength=n_rows)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(idt)
        cols = cols.astype(idt, copy=False)
        rows = rows.astype(idt, copy=False)
        data = to_device(vals, tdt)
        if tdt == torch.bfloat16:  # the host copy holds the rounded values
            vals = data.float().numpy()
        out = cls(indptr=to_device(indptr, None, device),
                  indices=to_device(cols, None, device), data=data.to(device),
                  row_ids=to_device(rows, None, device), shape=(n_rows, n_cols))
        return out._stash_host(indptr=indptr, indices=cols, data=vals, row_ids=rows)

    @classmethod
    def from_dense(cls, mat, *, index_dtype=DEFAULT_INDEX_DTYPE, device=None) -> "CSR":
        from .coo import COO

        return cls.from_coo(COO.from_dense(mat, index_dtype=index_dtype, device=device))

    @classmethod
    def from_scipy(cls, sp_mat, *, index_dtype=DEFAULT_INDEX_DTYPE, device=None) -> "CSR":
        sp_mat = sp_mat.tocsr()
        sp_mat.sort_indices()
        idt = host_dtype(index_dtype)
        return cls.from_arrays(np.asarray(sp_mat.indptr, idt),
                               np.asarray(sp_mat.indices, idt),
                               np.asarray(sp_mat.data), sp_mat.shape, device=device)

    @classmethod
    def eye(cls, dim: int, *, dtype=torch.float32,
            index_dtype=DEFAULT_INDEX_DTYPE, device=None) -> "CSR":
        idt = as_torch_dtype(index_dtype)
        device = resolve_device(device)
        idx = torch.arange(dim, dtype=idt, device=device)
        return cls(indptr=torch.arange(dim + 1, dtype=idt, device=device),
                   indices=idx,
                   data=torch.ones(dim, dtype=as_torch_dtype(dtype), device=device),
                   row_ids=idx, shape=(dim, dim))

    # -- canonical views ----------------------------------------------------------
    def to_csr(self) -> "CSR":
        return self

    def to_coo(self):
        from .coo import COO

        return COO(rows=self.row_ids, cols=self.indices, vals=self.data,
                   shape=self.shape, canonical=True)

    def to_ell(self, n_cols_per_row: int | None = None):
        from .ell import ELL

        return ELL.from_csr(self, n_cols_per_row=n_cols_per_row)

    # -- structure ----------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.indices.shape[0])

    @property
    def index_dtype(self):
        return self.indices.dtype

    def n_non_zero_entries(self) -> int:
        return int(self.host("indptr")[-1])

    def row_nnz(self) -> torch.Tensor:
        """Per-row entry counts."""
        return self.indptr[1:] - self.indptr[:-1]

    def max_row_nnz(self) -> int:
        """Host-side max entries per row."""
        return int(np.diff(self.host("indptr").astype(np.int64)).max(initial=0))

    def scale(self, scalar) -> "CSR":
        return dataclasses.replace(self, data=self.data * scalar)

    def diagonal(self) -> torch.Tensor:
        """The main diagonal, dense (the basis of Jacobi-type solvers).
        Duplicate diagonal entries are summed, as in the JAX package."""
        rid = self.row_ids.long()
        on_diag = (rid == self.indices.long()) & (rid < self.n_rows)
        d = torch.zeros(self.n_rows, dtype=self.data.dtype, device=self.data.device)
        return d.index_add_(0, rid[on_diag], self.data[on_diag])

    def prune(self, keep_zeros: bool = True) -> "CSR":
        """The same matrix without tail padding (and, with
        ``keep_zeros=False``, without stored zeros)."""
        return self.to_coo().prune(keep_zeros=keep_zeros).to_csr()

    # -- row and column access ------------------------------------------------------
    def get_row_dense(self, i: int) -> torch.Tensor:
        """Row i as a dense vector on the matrix's device."""
        ip = self.host("indptr")
        s, e = int(ip[i]), int(ip[i + 1])
        out = torch.zeros(self.n_cols, dtype=self.data.dtype, device=self.device)
        return out.index_put_((self.indices[s:e].long(),), self.data[s:e], accumulate=True)

    def get_row(self, i: int):
        """Row i as a ``SparseVec`` (host arrays)."""
        from ..vectors import SparseVec

        ip = self.host("indptr")
        s, e = int(ip[i]), int(ip[i + 1])
        return SparseVec(indices=self.host("indices")[s:e].copy(),
                         vals=self.host("data")[s:e].copy(), dim=self.n_cols)

    def iter_row(self, i: int):
        """(col, val) pairs of row i, column-sorted; a row out of range
        yields nothing."""
        if i < 0 or i >= self.n_rows:
            return
        indptr = self.host("indptr")
        indices = self.host("indices")
        data = self.host("data")
        for p in range(int(indptr[i]), int(indptr[i + 1])):
            yield int(indices[p]), data[p]

    def assemble_column_info(self) -> "CSR":
        """Build the column view (a host CSC) that ``iter_col`` reads.  A CSR
        never changes, so the view never goes stale.  Returns self."""
        if self.__dict__.get("_col_info") is None:
            indptr = self.host("indptr").astype(np.int64)
            indices = self.host("indices").astype(np.int64)
            data = self.host("data")
            nnz = int(indptr[-1])
            rows = np.repeat(np.arange(self.n_rows, dtype=np.int64), np.diff(indptr))
            order = np.lexsort((rows, indices[:nnz]))
            col_ptr = np.concatenate(
                [[0], np.cumsum(np.bincount(indices[:nnz], minlength=self.n_cols))])
            object.__setattr__(self, "_col_info", (col_ptr, rows[order], data[:nnz][order]))
        return self

    def iter_col(self, j: int):
        """(row, val) pairs of column j in ascending row order.  Raises
        unless ``assemble_column_info`` ran first."""
        info = self.__dict__.get("_col_info")
        if info is None:
            raise RuntimeError("column info is stale — call assemble_column_info() first")
        col_ptr, rows, vals = info
        if j < 0 or j >= self.n_cols:
            return
        for p in range(int(col_ptr[j]), int(col_ptr[j + 1])):
            yield int(rows[p]), vals[p]
