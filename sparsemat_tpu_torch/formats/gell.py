"""GELL — the gather-ELL ladder: a scatter-free layout for globally
scattered matrices (counterpart of ``sparsemat_tpu/formats/gell.py``).

Level 0 is an ELL over all rows with a K chosen by a slot-cost model; rows
with more than K entries continue into level ℓ + 1, an ELL over only those
rows, compacted.  A level's result joins y through ``y += y_level[inv_map]``,
a gather by the static inverse row map (``inv_maps[ℓ - 1]``, n_local for a
row absent from the level, which reads 0), never a scatter.  The ladder
recurses until every entry is placed (at most ``MAX_LEVELS``; the last level
takes K = the largest remaining count).  ``level_rows[ℓ - 1]`` is the global
row of each local row of level ℓ.

The JAX package has no kernel for it (its SpMV is plain gathers); neither
does the port.  The freeze gives the JAX package's arrays bit for bit (the
same host numpy program); the levels are the port's ``ELL``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..types import accum_dtype
from .base import SparseFormat, to_device
from .ell import ELL

#: recursion bound; the final level takes K = max remaining row count
MAX_LEVELS = 8
#: estimated slots one deferred entry costs in later levels (drives the
#: per-level K choice: minimise n_level*K + deferred*COST)
_DEFER_SLOT_COST = 3.0


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class GELL(SparseFormat):
    """Frozen gather-ELL ladder: ``levels`` (ELL, ...), ``inv_maps``
    ((n_rows,) int32 per level past the first), ``level_rows`` ((n_local,)
    int32 per level past the first)."""

    levels: Tuple[ELL, ...]
    inv_maps: Tuple[torch.Tensor, ...]
    level_rows: Tuple[torch.Tensor, ...]
    shape: Tuple[int, int]

    @classmethod
    def from_csr(cls, csr, k0: int | None = None) -> "GELL":
        """Host freeze.  ``k0`` pins level 0's K (default: the cost model)."""
        n_rows, n_cols = csr.shape
        dev, tdt = csr.device, csr.dtype
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int32)
        data = csr.host("data")

        levels, inv_maps, level_rows = [], [], []
        rows_l = np.arange(n_rows, dtype=np.int64)   # global row per local row
        consumed = np.zeros(n_rows, np.int64)
        counts = np.diff(indptr)
        for lvl in range(MAX_LEVELS):
            rem = counts[rows_l] - consumed[rows_l]
            if rows_l.size == 0:
                break
            rmax = int(rem.max(initial=0))
            if rmax == 0 and lvl > 0:
                break
            if lvl == 0 and k0 is not None:
                k = int(k0)
            elif lvl == MAX_LEVELS - 1:
                k = max(rmax, 1)
            else:
                cands = [1 << p for p in range(0, 14) if (1 << p) <= 2 * rmax]
                best_k, best_cost = max(rmax, 1), float("inf")
                for kc in cands:
                    deferred = np.maximum(rem - kc, 0).sum()
                    cost = rows_l.size * kc + deferred * _DEFER_SLOT_COST
                    if cost < best_cost:
                        best_k, best_cost = kc, cost
                k = best_k
            take = np.minimum(rem, k)
            n_l = rows_l.size
            j = np.arange(k, dtype=np.int64)
            src = (indptr[rows_l] + consumed[rows_l])[:, None] + j[None, :]
            valid = j[None, :] < take[:, None]
            src = np.where(valid, src, 0)
            cols_l = np.where(valid, indices[src], 0).astype(np.int32)
            vals_l = np.where(valid, data[src], 0)
            pad_r = -(-n_l // ELL.ROW_PAD) * ELL.ROW_PAD - n_l
            if pad_r:
                cols_l = np.concatenate([cols_l, np.zeros((pad_r, k), np.int32)])
                vals_l = np.concatenate([vals_l, np.zeros((pad_r, k), vals_l.dtype)])
                take_p = np.concatenate([take, np.zeros(pad_r, np.int64)])
            else:
                take_p = take
            levels.append(ELL(cols=to_device(cols_l, None, dev),
                              vals=to_device(vals_l, tdt, dev),
                              row_nnz=to_device(take_p.astype(np.int32), None, dev),
                              shape=(n_l, n_cols)))
            if lvl > 0:
                inv = np.full(n_rows, n_l, np.int32)
                inv[rows_l] = np.arange(n_l, dtype=np.int32)
                inv_maps.append(to_device(inv, None, dev))
                level_rows.append(to_device(rows_l.astype(np.int32), None, dev))
            consumed[rows_l] += take
            rows_l = rows_l[rem > k]
        return cls(levels=tuple(levels), inv_maps=tuple(inv_maps),
                   level_rows=tuple(level_rows), shape=(n_rows, n_cols))

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows = self.shape[0]
        rs, cs, vs = [], [], []
        for i, lvl in enumerate(self.levels):
            pc = lvl.to_coo()
            prow = pc.rows.long()
            if i == 0:
                rows = torch.where(prow < n_rows, prow, n_rows)
            else:
                lr = self.level_rows[i - 1].long()
                ok = prow < lr.shape[0]
                rows = torch.where(ok, lr[prow.clamp(0, lr.shape[0] - 1)], n_rows)
            rs.append(rows.to(torch.int32))
            cs.append(pc.cols)
            vs.append(torch.where(rows < n_rows, pc.vals, 0))
        return COO(rows=torch.cat(rs), cols=torch.cat(cs), vals=torch.cat(vs),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    def to_gell(self) -> "GELL":
        return self

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        return sum(lvl.nse for lvl in self.levels)

    @property
    def index_dtype(self):
        return torch.int32

    @property
    def data(self):
        return self.levels[0].vals

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def n_non_zero_entries(self) -> int:
        n = self.levels[0].n_non_zero_entries()
        for lvl, lr in zip(self.levels[1:], self.level_rows):
            n += int(lvl.row_nnz[: lr.shape[0]].sum())
        return n

    def scale(self, scalar) -> "GELL":
        return dataclasses.replace(self, levels=tuple(lvl.scale(scalar) for lvl in self.levels))

    def astype(self, dtype) -> "GELL":
        return dataclasses.replace(self, levels=tuple(lvl.astype(dtype) for lvl in self.levels))

    def fill_ratio(self) -> float:
        return self.n_non_zero_entries() / max(self.nse, 1)

    def spmv_traffic_bytes(self) -> int:
        """The layout's bytes per SpMV (the JAX package's count): every
        level's cols and vals, the continuation maps, x read once and y
        written once."""
        total = sum(lvl.cols.numel() * 4 + lvl.vals.numel() * lvl.vals.element_size()
                    for lvl in self.levels)
        total += sum(inv.numel() * 4 for inv in self.inv_maps)
        return int(total + self.shape[1] * self.dtype.itemsize
                   + self.shape[0] * accum_dtype(self.dtype).itemsize)
