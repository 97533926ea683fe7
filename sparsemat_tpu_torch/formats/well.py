"""WELL — windowed ELLPACK, the general-matrix format (counterpart of
``sparsemat_tpu/formats/well.py``).

Rows are grouped in blocks of 8; each row's entries are partitioned by the
128-wide column window they fall in; each (row block, window) pair with
entries is a *tile* of up to K entries per row: ``vals``/``lidx`` of shape
(8, K), ``lidx`` the column within the window.  A row denser than K in one
window continues in duplicate "overflow" tiles of the same (row block,
window), which add like any other.  Tiles are sorted by row block; a row
block with no entries gets one all-zero dummy tile.  ``row_cnt`` (n_tiles,
8) counts the stored entries per tile row: slots fill from 0, so slot <
count marks a stored entry (stored zeros survive a round trip).

The layout is the JAX package's, array for array and bit for bit (the freeze
below is the same host numpy program, uploaded once at the end, its host
arrays cached).  The JAX format also carries ``chunks``, the tile ranges
that bound each TPU call's scalar-prefetch arrays to SMEM: TPU scaffolding
that the port's CUDA kernel (the row-group SpMV, ``csrc/spmv.cu``) does
not need.  The checkpoint writes it (``chunk_bounds``) so that the JAX
package reads the port's files.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import SparseFormat, to_device

ROW_BLOCK = 8
WINDOW = 128
#: the JAX package's SMEM bound on tiles per TPU call (``chunk_bounds`` only)
MAX_TILES_PER_CALL = 60_000


def chunk_bounds(tile_rows: np.ndarray, n_rb: int, max_tiles: int = MAX_TILES_PER_CALL):
    """The JAX freeze's ``chunks``: the tile stream split at row-block
    boundaries into ranges of at most ``max_tiles`` tiles, as
    ((tile_start, tile_end, rb_start, rb_end), ...)."""
    t = int(tile_rows.shape[0])
    if t <= max_tiles:
        return ((0, t, 0, n_rb - 1),)
    rb_first = np.searchsorted(tile_rows, np.arange(n_rb + 1))
    rb_first[-1] = t
    bounds = []
    rb0 = 0
    while rb0 < n_rb:
        rb1 = rb0
        while rb1 + 1 < n_rb and rb_first[rb1 + 2] - rb_first[rb0] <= max_tiles:
            rb1 += 1
        bounds.append((int(rb_first[rb0]), int(rb_first[rb1 + 1]), rb0, rb1))
        rb0 = rb1 + 1
    return tuple(bounds)


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class WELL(SparseFormat):
    """Frozen windowed-ELL matrix: ``vals``/``lidx`` (n_tiles, 8, K),
    ``tile_rows``/``tile_wins`` (n_tiles,) int32 row block and window per
    tile, ``row_cnt`` (n_tiles, 8) int32 or None (then a nonzero value marks
    a stored entry)."""

    _spmv_read_fields = ("vals", "lidx", "tile_rows", "tile_wins")  # row_cnt: round trips only

    vals: torch.Tensor
    lidx: torch.Tensor
    tile_rows: torch.Tensor
    tile_wins: torch.Tensor
    row_cnt: Optional[torch.Tensor]
    shape: Tuple[int, int]

    @classmethod
    def from_csr(cls, csr, k_tile: int | None = None) -> "WELL":
        """Host freeze.  ``k_tile`` caps the entries per (row, window) in one
        tile (default: the largest count, at most 128); denser rows spill
        into overflow tiles."""
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        rb = rows[:nnz] // ROW_BLOCK
        win = indices[:nnz] // WINDOW
        lane = (indices[:nnz] % WINDOW).astype(np.int32)
        lrow = (rows[:nnz] % ROW_BLOCK).astype(np.int32)
        vals = data[:nnz]

        # order by (row block, window, local row): the tile grouping key
        order = np.lexsort((lrow, win, rb))
        rb, win, lane, lrow, vals = rb[order], win[order], lane[order], lrow[order], vals[order]
        key = rb * (int(n_cols) // WINDOW + 2) + win
        tile_start = np.ones(nnz, bool)
        tile_start[1:] = key[1:] != key[:-1]
        tile_id_raw = np.cumsum(tile_start) - 1

        # slot within (tile, local row)
        rkey = key * ROW_BLOCK + lrow
        new_run = np.ones(nnz, bool)
        new_run[1:] = rkey[1:] != rkey[:-1]
        run_starts = np.flatnonzero(new_run)
        slot = np.arange(nnz) - np.repeat(run_starts, np.diff(np.append(run_starts, nnz)))

        kmax = int(slot.max(initial=-1)) + 1 if nnz else 1
        if k_tile is None:
            k_tile = min(max(kmax, 1), WINDOW)
        # entries at slot >= k_tile go to duplicate overflow tiles
        level = slot // k_tile
        slot_in = slot % k_tile
        n_levels = int(level.max(initial=0)) + 1
        # tile identity (tile_id_raw, level), re-sorted so a row block's
        # tiles stay consecutive
        order2 = np.lexsort((slot_in, level, tile_id_raw))
        rb2, win2, lane2, lrow2, vals2 = (rb[order2], win[order2], lane[order2],
                                          lrow[order2], vals[order2])
        tkey = tile_id_raw[order2] * n_levels + level[order2]
        tstart = np.ones(nnz, bool)
        tstart[1:] = tkey[1:] != tkey[:-1]
        tid = np.cumsum(tstart) - 1
        n_tiles = int(tid.max(initial=-1)) + 1 if nnz else 0

        v_t = np.zeros((max(n_tiles, 1), ROW_BLOCK, k_tile), data.dtype)
        l_t = np.zeros((max(n_tiles, 1), ROW_BLOCK, k_tile), np.int32)
        v_t[tid, lrow2, slot_in[order2]] = vals2
        l_t[tid, lrow2, slot_in[order2]] = lane2
        c_t = np.zeros((max(n_tiles, 1), ROW_BLOCK), np.int32)
        np.add.at(c_t, (tid, lrow2), 1)
        t_rows = np.zeros(max(n_tiles, 1), np.int32)
        t_wins = np.zeros(max(n_tiles, 1), np.int32)
        t_rows[tid] = rb2.astype(np.int32)
        t_wins[tid] = win2.astype(np.int32)

        # a dummy all-zero tile for each row block with no entries
        n_rb = max(-(-n_rows // ROW_BLOCK), 1)
        present = np.zeros(n_rb, bool)
        if nnz:
            present[t_rows[:n_tiles]] = True
        else:
            n_tiles = 0
        missing = np.flatnonzero(~present).astype(np.int32)
        if missing.size:
            v_t = np.concatenate([v_t[:n_tiles],
                                  np.zeros((missing.size, ROW_BLOCK, k_tile), data.dtype)])
            l_t = np.concatenate([l_t[:n_tiles],
                                  np.zeros((missing.size, ROW_BLOCK, k_tile), np.int32)])
            c_t = np.concatenate([c_t[:n_tiles], np.zeros((missing.size, ROW_BLOCK), np.int32)])
            t_rows = np.concatenate([t_rows[:n_tiles], missing])
            t_wins = np.concatenate([t_wins[:n_tiles], np.zeros(missing.size, np.int32)])
            order3 = np.argsort(t_rows, kind="stable")
            v_t, l_t, c_t, t_rows, t_wins = (v_t[order3], l_t[order3], c_t[order3],
                                             t_rows[order3], t_wins[order3])
        dev = csr.device
        host = dict(lidx=l_t, tile_rows=t_rows, tile_wins=t_wins, row_cnt=c_t)
        out = cls(vals=to_device(v_t, csr.dtype, dev),
                  **{k: to_device(v, None, dev) for k, v in host.items()},
                  shape=(n_rows, n_cols))
        return out._stash_host(vals=v_t, **host)

    # -- canonical views ------------------------------------------------------
    def _stored_mask(self) -> torch.Tensor:
        """(n_tiles, 8, K) bool: the slot holds a stored entry (stored zeros
        included) rather than padding."""
        if self.row_cnt is None:
            return self.vals != 0
        k = torch.arange(self.k_tile, dtype=torch.int32, device=self.vals.device)
        return k[None, None, :] < self.row_cnt[:, :, None]

    def to_coo(self):
        from .coo import COO

        dev = self.vals.device
        rows = (self.tile_rows[:, None, None] * ROW_BLOCK
                + torch.arange(ROW_BLOCK, dtype=torch.int32, device=dev)[None, :, None])
        cols = self.tile_wins[:, None, None] * WINDOW + self.lidx
        stored = self._stored_mask().reshape(-1)
        return COO(rows=torch.where(stored, rows.expand(self.vals.shape).reshape(-1),
                                    self.shape[0]),
                   cols=torch.where(stored, cols.reshape(-1), 0),
                   vals=torch.where(stored, self.vals.reshape(-1), 0),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.vals.numel())

    @property
    def n_tiles(self) -> int:
        return int(self.vals.shape[0])

    @property
    def k_tile(self) -> int:
        return int(self.vals.shape[2])

    @property
    def n_row_blocks(self) -> int:
        return max(-(-self.shape[0] // ROW_BLOCK), 1)

    @property
    def index_dtype(self):
        return torch.int32

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self) -> int:
        if self.row_cnt is not None:
            return int(self.row_cnt.sum())
        return int(torch.count_nonzero(self.vals))

    def scale(self, scalar) -> "WELL":
        return dataclasses.replace(self, vals=self.vals * scalar)

    def fill_ratio(self) -> float:
        """Stored entries / slots."""
        return self.n_non_zero_entries() / max(self.nse, 1)
