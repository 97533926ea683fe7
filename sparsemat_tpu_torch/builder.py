"""Mutable assembly phase: SparseBuilder (counterpart of
``sparsemat_tpu/builder.py``).

Semantics of the reference's assembly format: insert-if-absent writes with
zero init, one entry per coordinate, a shape that grows from the touched
coordinates, row-major iteration with insertion order within a row, and
column iteration only after an explicit ``assemble_column_info()``.

The store is the shared C++ open-addressing hash accumulator
(``sparsemat_tpu/native/assembly.cc``, built by ``native/``), with a
pure-Python dict store where that library is unavailable.  Freezing
(``to_coo``/``to_csr``) runs on the host and uploads the frozen arrays to
the requested device once.  ``PartitionedBuilder`` assembles block rows in
sub-builders and freezes their union (the distributed layer, ``parallel/``,
partitions a frozen matrix itself).
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import numpy as np
import torch

from .types import (DEFAULT_INDEX_DTYPE, check_index_dtype, check_value_dtype, host_dtype,
                    resolve_device)
from .vectors import SparseVec


class _NativeStore:
    """ctypes wrapper over the C++ builder."""

    def __init__(self, lib, capacity: int):
        self._lib = lib
        self._h = lib.smt_builder_new(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.smt_builder_free(self._h)
            self._h = None

    def add_to(self, i, j, v):
        self._lib.smt_builder_add_to(self._h, i, j, float(v))

    def set(self, i, j, v):
        self._lib.smt_builder_set(self._h, i, j, float(v))

    def get(self, i, j):
        return self._lib.smt_builder_get(self._h, i, j)

    def _batch(self, fn, rows, cols, vals):
        rows = np.ascontiguousarray(rows, np.int64)
        cols = np.ascontiguousarray(cols, np.int64)
        vals = np.ascontiguousarray(vals, np.float64)
        if not rows.shape == cols.shape == vals.shape:
            raise ValueError("rows/cols/vals must have one length")
        fn(self._h, rows.shape[0],
           rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
           cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
           vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    def add_batch(self, rows, cols, vals):
        self._batch(self._lib.smt_builder_add_batch, rows, cols, vals)

    def set_batch(self, rows, cols, vals):
        self._batch(self._lib.smt_builder_set_batch, rows, cols, vals)

    @property
    def nnz(self):
        return int(self._lib.smt_builder_nnz(self._h))

    @property
    def n_rows(self):
        return int(self._lib.smt_builder_n_rows(self._h))

    @property
    def n_cols(self):
        return int(self._lib.smt_builder_n_cols(self._h))

    def scale(self, s):
        self._lib.smt_builder_scale(self._h, float(s))

    def export_insertion(self):
        n = self.nnz
        rows = np.empty(n, np.int64)
        cols = np.empty(n, np.int64)
        vals = np.empty(n, np.float64)
        self._lib.smt_builder_export(
            self._h,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return rows, cols, vals


class _PyStore:
    """Pure-Python store: a dict keyed (i, j), whose insertion order gives
    the chain-order semantics."""

    def __init__(self, capacity: int):
        self._d: dict[Tuple[int, int], float] = {}
        self.n_rows = 0
        self.n_cols = 0

    def _touch(self, i, j):
        if i >= self.n_rows:
            self.n_rows = i + 1
        if j >= self.n_cols:
            self.n_cols = j + 1

    def add_to(self, i, j, v):
        self._touch(i, j)
        self._d[(i, j)] = self._d.get((i, j), 0.0) + float(v)

    def set(self, i, j, v):
        self._touch(i, j)
        self._d[(i, j)] = float(v)

    def get(self, i, j):
        return self._d.get((i, j), 0.0)

    def add_batch(self, rows, cols, vals):
        for i, j, v in zip(np.asarray(rows).tolist(), np.asarray(cols).tolist(),
                           np.asarray(vals).tolist()):
            self.add_to(i, j, v)

    def set_batch(self, rows, cols, vals):
        for i, j, v in zip(np.asarray(rows).tolist(), np.asarray(cols).tolist(),
                           np.asarray(vals).tolist()):
            self.set(i, j, v)

    @property
    def nnz(self):
        return len(self._d)

    def scale(self, s):
        for key in self._d:
            self._d[key] *= s

    def export_insertion(self):
        if not self._d:
            return (np.array([], np.int64), np.array([], np.int64),
                    np.array([], np.float64))
        ks = np.array(list(self._d.keys()), np.int64)
        vs = np.array(list(self._d.values()), np.float64)
        return ks[:, 0], ks[:, 1], vs


class SparseBuilder:
    """Incremental sparse-matrix assembly (host side)."""

    def __init__(self, capacity: int = 16, *, dtype=torch.float32,
                 index_dtype=DEFAULT_INDEX_DTYPE, shape=None):
        from .native import get_lib

        lib = get_lib()
        self._store = _NativeStore(lib, capacity) if lib is not None else _PyStore(capacity)
        self.dtype = check_value_dtype(dtype)
        self.index_dtype = check_index_dtype(index_dtype)
        self._np_dtype = host_dtype(self.dtype)
        self._fixed_shape = tuple(shape) if shape is not None else None
        self._column_info_fresh = False
        self._iter_cache = None
        #: row → entry count when sort_row ran (later entries follow the
        #: sorted prefix in insertion order)
        self._row_sorted_upto: dict[int, int] = {}

    @classmethod
    def with_capacity(cls, capacity: int, **kw) -> "SparseBuilder":
        return cls(capacity, **kw)

    @classmethod
    def eye(cls, dim: int, **kw) -> "SparseBuilder":
        b = cls(dim, **kw)
        idx = np.arange(dim)
        b.set_batch(idx, idx, np.ones(dim))
        return b

    @property
    def native(self) -> bool:
        """True when the C++ store holds the entries."""
        return isinstance(self._store, _NativeStore)

    # -- shape ------------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        if self._fixed_shape is not None:
            return (max(self._fixed_shape[0], self._store.n_rows),
                    max(self._fixed_shape[1], self._store.n_cols))
        return (self._store.n_rows, self._store.n_cols)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self._store.nnz

    def n_non_zero_entries(self) -> int:
        return self._store.nnz

    # -- writes (insert-if-absent, one entry per coordinate) ---------------------
    def _mutated(self):
        self._column_info_fresh = False
        self._iter_cache = None

    def add_to(self, i: int, j: int, v) -> None:
        self._mutated()
        self._store.add_to(int(i), int(j), v)

    def set(self, i: int, j: int, v) -> None:
        self._mutated()
        self._store.set(int(i), int(j), v)

    def get(self, i: int, j: int):
        return self._np_dtype.type(self._store.get(int(i), int(j)))

    def __setitem__(self, ij, v):
        self.set(ij[0], ij[1], v)

    def __getitem__(self, ij):
        return self.get(ij[0], ij[1])

    def add_batch(self, rows, cols, vals) -> None:
        """Vectorized add_to — the recommended assembly path."""
        self._mutated()
        self._store.add_batch(rows, cols, vals)

    def set_batch(self, rows, cols, vals) -> None:
        self._mutated()
        self._store.set_batch(rows, cols, vals)

    def scale(self, s) -> "SparseBuilder":
        # values change; structure and column-info freshness do not
        self._iter_cache = None
        self._store.scale(s)
        return self

    # -- sorting ----------------------------------------------------------------
    def sort_row(self, i: int) -> None:
        """Make row i iterate column-sorted; entries inserted later follow
        the sorted prefix.  Freezes canonicalize regardless."""
        self._row_sorted_upto[int(i)] = sum(1 for _ in self.iter_row(int(i)))

    def sort(self) -> None:
        for i in range(self.n_rows):
            self.sort_row(i)

    # -- iteration (reference order semantics) -----------------------------------
    def __iter__(self) -> Iterator[Tuple[int, int, float]]:
        """Row-major, insertion order within each row."""
        for i in range(self.n_rows):
            for j, v in self.iter_row(i):
                yield i, j, v

    def _insertion_view(self):
        """Cached insertion-order export plus per-row/per-column position
        indexes, rebuilt only after mutations."""
        if self._iter_cache is None:
            rows, cols, vals = self._store.export_insertion()
            nr, nc = self.shape
            ro = np.argsort(rows, kind="stable")
            rptr = np.zeros(nr + 2, np.int64)
            np.add.at(rptr, rows + 1, 1)
            rptr = np.cumsum(rptr)
            co = np.argsort(cols, kind="stable")
            cptr = np.zeros(nc + 2, np.int64)
            np.add.at(cptr, cols + 1, 1)
            cptr = np.cumsum(cptr)
            self._iter_cache = (rows, cols, vals, ro, rptr, co, cptr)
        return self._iter_cache

    def iter_row(self, i: int) -> Iterator[Tuple[int, float]]:
        """(col, val) pairs of row i in insertion order."""
        rows, cols, vals, ro, rptr, _, _ = self._insertion_view()
        if i < 0 or i + 1 >= len(rptr):
            return
        pos = ro[rptr[i]:rptr[i + 1]]
        k = self._row_sorted_upto.get(i, 0)
        if k:
            head = sorted(pos[:k], key=lambda p: cols[p])
            pos = list(head) + list(pos[k:])
        for p in pos:
            yield int(cols[p]), self._np_dtype.type(vals[p])

    def assemble_column_info(self) -> None:
        """Mark column iteration valid until the next mutation."""
        self._column_info_fresh = True

    def iter_col(self, j: int) -> Iterator[Tuple[int, float]]:
        """(row, val) pairs of column j in insertion order.  Raises unless
        ``assemble_column_info`` ran since the last mutation."""
        if not self._column_info_fresh:
            raise RuntimeError(
                "column info is stale — call assemble_column_info() first")
        rows, cols, vals, _, _, co, cptr = self._insertion_view()
        if j < 0 or j + 1 >= len(cptr):
            return
        for p in co[cptr[j]:cptr[j + 1]]:
            yield int(rows[p]), self._np_dtype.type(vals[p])

    def get_row(self, i: int) -> SparseVec:
        """Row i as a SparseVec, in insertion order."""
        cols_vals = list(self.iter_row(i))
        cols, vals = zip(*cols_vals) if cols_vals else ((), ())
        return SparseVec(np.array(cols, np.int64), np.array(vals, self._np_dtype),
                         self.n_cols)

    def density(self) -> float:
        nr, nc = self.shape
        return self.nnz / (nr * nc) if nr and nc else 0.0

    def sparsity(self) -> float:
        return 1.0 - self.density()

    # -- freeze to device formats --------------------------------------------------
    def to_coo(self, *, pad_to: int | None = None, device=None):
        """Freeze to canonical COO on ``device``.  ``pad_to`` reserves
        extra (padding) slots.  ``device`` None: the current CUDA card."""
        from .formats.coo import COO

        device = resolve_device(device)
        rows, cols, vals = self._store.export_insertion()
        order = np.lexsort((cols, rows))
        nr, nc = self.shape
        rows, cols, vals = rows[order], cols[order], vals[order]
        if pad_to is not None and pad_to > rows.shape[0]:
            extra = pad_to - rows.shape[0]
            rows = np.concatenate([rows, np.full(extra, nr, np.int64)])
            cols = np.concatenate([cols, np.zeros(extra, np.int64)])
            vals = np.concatenate([vals, np.zeros(extra)])
        idt = host_dtype(self.index_dtype)
        return COO(rows=torch.from_numpy(rows.astype(idt)).to(device),
                   cols=torch.from_numpy(cols.astype(idt)).to(device),
                   vals=torch.from_numpy(vals).to(self.dtype).to(device),
                   shape=(nr, nc), canonical=True)

    def to_csr(self, *, pad_to: int | None = None, device=None):
        """Freeze to CSR on ``device`` (host-side sort, one upload; None:
        the current CUDA card)."""
        device = resolve_device(device)
        if pad_to is not None:
            return self.to_coo(pad_to=pad_to, device=device).to_csr()
        from .formats.csr import CSR

        rows, cols, vals = self._store.export_insertion()
        return CSR.from_host_coo(rows, cols, vals, self.shape,
                                 dtype=self.dtype, index_dtype=self.index_dtype,
                                 sum_duplicates=False, device=device)

    def to_ell(self, n_cols_per_row: int | None = None, *, device=None):
        """Freeze to ELL on ``device`` (through CSR)."""
        return self.to_csr(device=device).to_ell(n_cols_per_row=n_cols_per_row)

    def freeze(self, format: str = "csr", device=None):
        return getattr(self, f"to_{format}")(device=device)

    def mvp(self, x):
        """y = A·x on x's device where x is a tensor, else on the current
        CUDA card."""
        from .ops import spmv

        device = x.device if isinstance(x, torch.Tensor) else resolve_device(None)
        x = torch.as_tensor(x, device=device)
        return spmv(self.to_csr(device=device), x)

    def todense(self) -> np.ndarray:
        rows, cols, vals = self._store.export_insertion()
        out = np.zeros(self.shape, self._np_dtype)
        np.add.at(out, (rows, cols), vals.astype(out.dtype))
        return out

    def __repr__(self):
        return (f"SparseBuilder(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype}, backend={'native' if self.native else 'python'})")


class PartitionedBuilder:
    """Block-row partitioned assembly (counterpart of the JAX package's
    ``PartitionedBuilder``).

    ``n_blocks`` sub-builders each own ``max_n_rows // n_blocks`` contiguous
    rows; a write goes to block ``row // rows_per_block``, clamped to the
    last block, which also takes the rows past ``n_blocks ·
    rows_per_block``.  A freeze is one lexsort over the blocks' insertion
    exports: the same canonical COO or CSR as one ``SparseBuilder`` holding
    the same entries."""

    def __init__(self, n_blocks: int, max_n_rows: int, **kw):
        if n_blocks < 1 or max_n_rows < n_blocks:
            raise ValueError("need n_blocks >= 1 and max_n_rows >= n_blocks")
        self.n_blocks = n_blocks
        self.rows_per_block = max_n_rows // n_blocks
        self.max_n_rows = max_n_rows
        self.blocks = [SparseBuilder(**kw) for _ in range(n_blocks)]

    @classmethod
    def with_sub_matrices(cls, n_blocks: int, max_n_rows: int, **kw):
        return cls(n_blocks, max_n_rows, **kw)

    def _route(self, i: int) -> Tuple[int, int]:
        b = min(i // self.rows_per_block, self.n_blocks - 1)
        return b, i - b * self.rows_per_block

    def add_to(self, i, j, v):
        b, r = self._route(int(i))
        self.blocks[b].add_to(r, j, v)

    def set(self, i, j, v):
        b, r = self._route(int(i))
        self.blocks[b].set(r, j, v)

    def get(self, i, j):
        b, r = self._route(int(i))
        return self.blocks[b].get(r, j)

    def __setitem__(self, ij, v):
        self.set(ij[0], ij[1], v)

    def __getitem__(self, ij):
        return self.get(ij[0], ij[1])

    @property
    def nnz(self) -> int:
        return sum(b.nnz for b in self.blocks)

    @property
    def shape(self) -> Tuple[int, int]:
        n_rows = 0
        n_cols = 0
        for k, b in enumerate(self.blocks):
            if b.nnz:
                n_rows = max(n_rows, k * self.rows_per_block + b.n_rows)
            n_cols = max(n_cols, b.n_cols)
        return (n_rows, n_cols)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def density(self) -> float:
        nr, nc = self.shape
        return self.nnz / (nr * nc) if nr and nc else 0.0

    def __iter__(self):
        for k, blk in enumerate(self.blocks):
            off = k * self.rows_per_block
            for i, j, v in blk:
                yield i + off, j, v

    def iter_row(self, i: int):
        b, r = self._route(int(i))
        return self.blocks[b].iter_row(r)

    def _triplets(self):
        """Every block's insertion export, rows made global, in (row, col)
        order."""
        parts = [blk._store.export_insertion() for blk in self.blocks]
        rows = np.concatenate([r + k * self.rows_per_block for k, (r, _, _) in enumerate(parts)])
        cols = np.concatenate([c for _, c, _ in parts])
        vals = np.concatenate([v for _, _, v in parts])
        order = np.lexsort((cols, rows))
        return rows[order], cols[order], vals[order]

    def to_coo(self, *, device=None):
        """Freeze the union of the blocks into one canonical COO on
        ``device`` (None: the current CUDA card)."""
        from .formats.coo import COO

        device = resolve_device(device)
        rows, cols, vals = self._triplets()
        b0 = self.blocks[0]
        idt = host_dtype(b0.index_dtype)
        return COO(rows=torch.from_numpy(rows.astype(idt)).to(device),
                   cols=torch.from_numpy(cols.astype(idt)).to(device),
                   vals=torch.from_numpy(vals).to(b0.dtype).to(device),
                   shape=self.shape, canonical=True)

    def to_csr(self, *, device=None):
        """Freeze the union of the blocks into CSR on ``device`` (None: the
        current CUDA card), by ``SparseBuilder.to_csr``'s host path."""
        from .formats.csr import CSR

        b0 = self.blocks[0]
        return CSR.from_host_coo(*self._triplets(), self.shape, dtype=b0.dtype,
                                 index_dtype=b0.index_dtype, sum_duplicates=False,
                                 device=resolve_device(device))

    def mvp(self, x):
        """y = A·x on x's device where x is a tensor, else on the current
        CUDA card."""
        from .ops import spmv

        device = x.device if isinstance(x, torch.Tensor) else resolve_device(None)
        return spmv(self.to_csr(device=device), torch.as_tensor(x, device=device))
