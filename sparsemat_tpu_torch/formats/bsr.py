"""BSR — block-sparse rows, the SpMM format (counterpart of
``sparsemat_tpu/formats/bsr.py``).

The nonzero (br × bc) blocks of the matrix are stored densely, so
``Y = A @ B`` is one dense block product per stored block per column tile
of B (``kernels/spmm.py``).

Layout (the JAX package's, array for array and bit for bit):

* ``blocks``:     (T, br, bc) dense values (zero-filled);
* ``block_rows``: (T,) block-row id per tile, ascending;
* ``block_cols``: (T,) block-column id per tile;
* ``occ``:        (T, br, bc) bool stored-entry mask, or None (then a
  nonzero value marks a stored entry).

Every block row holds at least one tile (an all-zero one where the row is
empty), as in the JAX package, whose kernel zeroes an output block on its
first visit.  The block shape stays (8k, 128k) so that every layout of the
JAX package can be reproduced.  The JAX package's ``chunks`` (tile ranges
sized for the TPU's scalar memory) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import SparseFormat, to_device

BLOCK_ROWS = 8
BLOCK_COLS = 128


def _check_block_shape(br: int, bc: int) -> None:
    if br <= 0 or bc <= 0 or br % 8 or bc % 128:
        raise ValueError(f"block shape ({br},{bc}) must be (8k, 128k), the JAX "
                         "package's aligned tiles")


def _entries(csr):
    """Host (rows, cols) of the CSR's valid entries, int64."""
    indptr = csr.host("indptr").astype(np.int64)
    indices = csr.host("indices").astype(np.int64)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64), np.diff(indptr))[:nnz]
    return rows, indices[:nnz], nnz


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class BSR(SparseFormat):
    """Frozen block-sparse-row matrix."""

    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    occ: Optional[torch.Tensor]
    shape: Tuple[int, int]

    @classmethod
    def from_csr(cls, csr, br: int = BLOCK_ROWS, bc: int = BLOCK_COLS) -> "BSR":
        """Host freeze: bucket the entries into (br × bc) blocks and keep the
        nonempty ones, plus one all-zero tile for each empty block row."""
        _check_block_shape(br, bc)
        n_rows, n_cols = csr.shape
        dev = csr.device
        rows, cols, nnz = _entries(csr)
        vals = csr.host("data")[:nnz]

        brow = rows // br
        bcol = cols // bc
        n_bc = max(-(-n_cols // bc), 1)
        key = brow * n_bc + bcol
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        start = np.ones(nnz, bool)
        start[1:] = key_s[1:] != key_s[:-1]
        tid = np.cumsum(start) - 1
        n_tiles = int(tid[-1]) + 1 if nnz else 0

        blocks = np.zeros((max(n_tiles, 1), br, bc), vals.dtype)
        occ = np.zeros((max(n_tiles, 1), br, bc), bool)
        t_rows = np.zeros(max(n_tiles, 1), np.int32)
        t_cols = np.zeros(max(n_tiles, 1), np.int32)
        if nnz:
            blocks[tid, rows[order] % br, cols[order] % bc] = vals[order]
            occ[tid, rows[order] % br, cols[order] % bc] = True
            t_rows[tid] = brow[order].astype(np.int32)
            t_cols[tid] = bcol[order].astype(np.int32)

        n_br = max(-(-n_rows // br), 1)
        present = np.zeros(n_br, bool)
        if nnz:
            present[t_rows[:n_tiles]] = True
        missing = np.flatnonzero(~present).astype(np.int32)
        if missing.size:
            blocks = np.concatenate([blocks[:n_tiles],
                                     np.zeros((missing.size, br, bc), vals.dtype)])
            occ = np.concatenate([occ[:n_tiles], np.zeros((missing.size, br, bc), bool)])
            t_rows = np.concatenate([t_rows[:n_tiles], missing])
            t_cols = np.concatenate([t_cols[:n_tiles], np.zeros(missing.size, np.int32)])
            order2 = np.argsort(t_rows, kind="stable")
            blocks, occ, t_rows, t_cols = (blocks[order2], occ[order2],
                                           t_rows[order2], t_cols[order2])
        host = dict(block_rows=t_rows, block_cols=t_cols, occ=occ)
        out = cls(blocks=to_device(blocks, csr.dtype, dev),
                  **{k: to_device(v, None, dev) for k, v in host.items()},
                  shape=(n_rows, n_cols))
        return out._stash_host(**host)

    @classmethod
    def from_coo(cls, coo, br: int = BLOCK_ROWS, bc: int = BLOCK_COLS) -> "BSR":
        return cls.from_csr(coo.to_csr(), br=br, bc=bc)

    @classmethod
    def from_csr_device(cls, csr, br: int = BLOCK_ROWS, bc: int = BLOCK_COLS) -> "BSR":
        """Device freeze for large, low-fill matrices: the host computes only
        the O(nnz) integer bookkeeping, and the dense block array is filled
        by one scatter of ``csr.data`` on its own device (unique positions,
        so deterministic).  Builds no ``occ``; the host ``block_rows`` and
        ``block_cols`` stay cached."""
        _check_block_shape(br, bc)
        n_rows, n_cols = csr.shape
        dev = csr.data.device
        rows, cols, nnz = _entries(csr)
        brow = rows // br
        bcol = cols // bc
        n_bc = max(-(-n_cols // bc), 1)
        key = brow * n_bc + bcol
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        start = np.ones(nnz, bool)
        if nnz:
            start[1:] = key_s[1:] != key_s[:-1]
        tid = np.cumsum(start) - 1 if nnz else np.zeros(0, np.int64)
        n_tiles = int(tid[-1]) + 1 if nnz else 0
        firsts = np.flatnonzero(start) if nnz else np.zeros(0, np.int64)
        t_rows = (key_s[firsts] // n_bc).astype(np.int32)
        t_cols = (key_s[firsts] % n_bc).astype(np.int32)

        n_br = max(-(-n_rows // br), 1)
        present = np.zeros(n_br, bool)
        present[t_rows] = True
        missing = np.flatnonzero(~present).astype(np.int32)
        t_rows_all = np.concatenate([t_rows, missing])
        t_cols_all = np.concatenate([t_cols, np.zeros(missing.size, np.int32)])
        order2 = np.argsort(t_rows_all, kind="stable")
        inv2 = np.empty_like(order2)
        inv2[order2] = np.arange(order2.size)
        t_rows_all = t_rows_all[order2]
        t_cols_all = t_cols_all[order2]
        n_all = n_tiles + missing.size

        # int64 positions: T·br·bc passes 2³¹ at the benchmark's shape
        pos = inv2[tid] if nnz else tid
        lin = pos * (br * bc) + (rows[order] % br) * bc + cols[order] % bc
        flat = torch.zeros(max(n_all, 1) * br * bc, dtype=csr.data.dtype, device=dev)
        if nnz:
            src = csr.data[torch.from_numpy(order).to(dev)]
            flat[torch.from_numpy(lin).to(dev)] = src
        out = cls(blocks=flat.reshape(max(n_all, 1), br, bc),
                  block_rows=to_device(t_rows_all, None, dev),
                  block_cols=to_device(t_cols_all, None, dev), occ=None,
                  shape=(n_rows, n_cols))
        return out._stash_host(block_rows=t_rows_all, block_cols=t_cols_all)

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        _, br, bc = self.blocks.shape
        dev = self.blocks.device
        rows = (self.block_rows[:, None, None].to(torch.int32) * br
                + torch.arange(br, dtype=torch.int32, device=dev)[None, :, None])
        cols = (self.block_cols[:, None, None].to(torch.int32) * bc
                + torch.arange(bc, dtype=torch.int32, device=dev)[None, None, :])
        rows = rows.expand(self.blocks.shape).reshape(-1)
        cols = cols.expand(self.blocks.shape).reshape(-1)
        vals = self.blocks.reshape(-1)
        stored = self.occ.reshape(-1) if self.occ is not None else vals != 0
        n_rows = self.shape[0]
        return COO(rows=torch.where(stored, rows, n_rows),
                   cols=torch.where(stored, cols, 0),
                   vals=torch.where(stored, vals, 0),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.blocks.numel())

    @property
    def n_tiles(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def br(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def bc(self) -> int:
        return int(self.blocks.shape[2])

    @property
    def index_dtype(self):
        return torch.int32

    @property
    def data(self):
        return self.blocks

    def n_non_zero_entries(self) -> int:
        if self.occ is not None:
            return int(self.occ.sum())
        return int(torch.count_nonzero(self.blocks))

    def scale(self, scalar) -> "BSR":
        return dataclasses.replace(self, blocks=self.blocks * scalar)

    def fill_ratio(self) -> float:
        """Stored / padded slots."""
        return self.n_non_zero_entries() / max(self.nse, 1)
