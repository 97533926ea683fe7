"""RowVec — ragged per-row assembly format (counterpart of
``sparsemat_tpu/formats/rowvec.py``).

A host-side staging structure: one Python list of columns and one of
values per row.  ``push`` appends without dedup; ``set`` and ``add_to``
find the column in the row first.  Per-row insertion order shows through
the iterators until ``sort_row``/``sort``.  ``iter_row`` raises on a row
out of range.  There is no column iterator.  Compute happens after a freeze
to CSR or COO, which, like every entry point of the port, builds on the
current CUDA card unless given ``device=``.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from ..types import DEFAULT_INDEX_DTYPE, as_torch_dtype, host_dtype, resolve_device
from ..vectors import SparseVec
from .base import to_device


class RowVec:
    """Ragged per-row sparse matrix (host side, mutable)."""

    def __init__(self, capacity: int = 0, *, dtype=torch.float32,
                 index_dtype=DEFAULT_INDEX_DTYPE):
        self._cols: List[List[int]] = [[] for _ in range(capacity)]
        self._vals: List[List[float]] = [[] for _ in range(capacity)]
        self._nnz = 0
        self._n_cols = 0
        self.dtype = as_torch_dtype(dtype)
        self.index_dtype = as_torch_dtype(index_dtype)
        self._np_dtype = host_dtype(self.dtype)

    @classmethod
    def with_capacity(cls, capacity: int, **kw) -> "RowVec":
        return cls(capacity, **kw)

    @classmethod
    def eye(cls, dim: int, **kw) -> "RowVec":
        m = cls(dim, **kw)
        for i in range(dim):
            m.push(i, i, 1.0)
        return m

    # -- shape ------------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (len(self._cols), self._n_cols)

    @property
    def n_rows(self) -> int:
        return len(self._cols)

    @property
    def n_cols(self) -> int:
        return self._n_cols

    @property
    def nnz(self) -> int:
        return self._nnz

    def n_non_zero_entries(self) -> int:
        return self._nnz

    def _grow(self, i: int, j: int) -> None:
        while len(self._cols) <= i:
            self._cols.append([])
            self._vals.append([])
        if j >= self._n_cols:
            self._n_cols = j + 1

    # -- writes -----------------------------------------------------------------
    def find_index(self, i: int, j: int) -> int | None:
        """Position of column j in row i, by a linear scan."""
        if i >= len(self._cols):
            return None
        try:
            return self._cols[i].index(j)
        except ValueError:
            return None

    def push(self, i: int, j: int, v) -> None:
        """Append (i, j, v) without dedup."""
        self._grow(int(i), int(j))
        self._cols[i].append(int(j))
        self._vals[i].append(float(v))
        self._nnz += 1

    def set(self, i: int, j: int, v) -> None:
        """Insert or overwrite."""
        p = self.find_index(int(i), int(j))
        if p is None:
            self.push(i, j, v)
        else:
            self._vals[i][p] = float(v)

    def add_to(self, i: int, j: int, v) -> None:
        """Insert or accumulate."""
        p = self.find_index(int(i), int(j))
        if p is None:
            self.push(i, j, v)
        else:
            self._vals[i][p] += float(v)

    def get(self, i: int, j: int):
        p = self.find_index(int(i), int(j))
        return self._np_dtype.type(self._vals[i][p] if p is not None else 0)

    def __setitem__(self, ij, v):
        self.set(ij[0], ij[1], v)

    def __getitem__(self, ij):
        return self.get(ij[0], ij[1])

    def scale(self, s) -> "RowVec":
        s = float(s)
        for row in self._vals:
            for p in range(len(row)):
                row[p] *= s
        return self

    # -- iteration ----------------------------------------------------------------
    def iter_row(self, i: int) -> Iterator[Tuple[int, float]]:
        """(col, val) pairs of row i in insertion order; IndexError out of
        range."""
        if i >= len(self._cols):
            raise IndexError(f"iter_row: row {i} out of range for {len(self._cols)} rows")
        return zip(self._cols[i], (self._np_dtype.type(v) for v in self._vals[i]))

    def __iter__(self) -> Iterator[Tuple[int, int, float]]:
        """Row-major (row, col, val) over every entry, skipping empty rows."""
        for i in range(len(self._cols)):
            for j, v in zip(self._cols[i], self._vals[i]):
                yield i, j, self._np_dtype.type(v)

    def get_row(self, i: int) -> SparseVec:
        return SparseVec(np.array(self._cols[i], np.int64),
                         np.array(self._vals[i], self._np_dtype), self._n_cols)

    # -- sorting ------------------------------------------------------------------
    def sort_row(self, i: int) -> None:
        order = np.argsort(self._cols[i], kind="stable")
        self._cols[i] = [self._cols[i][p] for p in order]
        self._vals[i] = [self._vals[i][p] for p in order]

    def sort(self) -> "RowVec":
        for i in range(len(self._cols)):
            self.sort_row(i)
        return self

    def is_sorted_row(self, i: int) -> bool:
        c = self._cols[i]
        return all(c[p] < c[p + 1] for p in range(len(c) - 1))

    def is_sorted(self) -> bool:
        return all(self.is_sorted_row(i) for i in range(len(self._cols)))

    # -- structure queries ----------------------------------------------------------
    def density(self) -> float:
        nr, nc = self.shape
        return self._nnz / (nr * nc) if nr and nc else 0.0

    def sparsity(self) -> float:
        return 1.0 - self.density()

    # -- freezes --------------------------------------------------------------------
    def _triplets(self):
        """(rows, cols, vals) on the host, row-major, insertion order in a row."""
        rows = np.repeat(np.arange(len(self._cols), dtype=np.int64),
                         [len(c) for c in self._cols])
        if not self._nnz:
            return rows, np.array([], np.int64), np.array([], np.float64)
        return (rows, np.concatenate([np.asarray(c, np.int64) for c in self._cols]),
                np.concatenate([np.asarray(v, np.float64) for v in self._vals]))

    def to_coo(self, device=None):
        """A COO sorted by (row, col) (pushed duplicates stay, adjacent), on
        ``device`` (None: the current CUDA card)."""
        from .coo import COO

        device = resolve_device(device)
        rows, cols, vals = self._triplets()
        order = np.lexsort((cols, rows))
        return COO(rows=to_device(rows[order], self.index_dtype, device),
                   cols=to_device(cols[order], self.index_dtype, device),
                   vals=to_device(vals[order], self.dtype, device),
                   shape=self.shape, canonical=True)

    def to_csr(self, device=None):
        """A CSR on ``device`` (None: the current CUDA card); pushed
        duplicates keep a slot each."""
        from .csr import CSR

        rows, cols, vals = self._triplets()
        return CSR.from_host_coo(rows, cols, vals, self.shape, dtype=self.dtype,
                                 index_dtype=self.index_dtype, sum_duplicates=False,
                                 device=device)

    def to_ell(self, n_cols_per_row: int | None = None, device=None):
        return self.to_csr(device=device).to_ell(n_cols_per_row=n_cols_per_row)

    def freeze(self, format: str = "csr", device=None):
        return getattr(self, f"to_{format}")(device=device)

    # -- convenience compute ----------------------------------------------------------
    def mvp(self, x, device=None):
        """A·x through a CSR freeze on ``device`` (None: the current CUDA card)."""
        from ..ops import spmv

        csr = self.to_csr(device=device)
        return spmv(csr, torch.as_tensor(x, device=csr.device))

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, self._np_dtype)
        for i, j, v in self:
            out[i, j] += v
        return out

    def __repr__(self):
        return f"RowVec(shape={self.shape}, nnz={self._nnz}, dtype={self.dtype})"
