"""SELL-C-σ (sliced ELLPACK) — padding-efficient layout for skewed rows
(counterpart of ``sparsemat_tpu/formats/sell.py``).

Rows are sorted by entry count within windows of σ rows and grouped into
slices of C rows, each padded only to its own longest row.  Storage is the
flat slot stream (``slot_rows``/``slot_cols``/``slot_vals``), slice-major,
each slice C rows × k slots row-major; ``slice_offsets`` gives each slice's
first slot.  Compute treats it as padded COO (padding: row = n_rows,
col = 0, val = 0); the JAX package has no kernel for it either.

The freeze gives the JAX package's arrays bit for bit: its per-slice Python
loop is written here as one vectorised scatter over the same slots.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import SparseFormat, to_device


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class SELL(SparseFormat):
    """Frozen sliced-ELL matrix: ``slot_rows``/``slot_cols``/``slot_vals``
    (n_slots,), ``slice_offsets`` (n_slices + 1,) int32."""

    slot_rows: torch.Tensor
    slot_cols: torch.Tensor
    slot_vals: torch.Tensor
    slice_offsets: torch.Tensor
    shape: Tuple[int, int]
    slice_height: int

    @classmethod
    def from_csr(cls, csr, slice_height: int = 8, sigma: int | None = None) -> "SELL":
        """Host freeze.  ``sigma`` is the row-sorting window (default the
        whole matrix, SELL-C-∞)."""
        c = int(slice_height)
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr")
        indices = csr.host("indices")
        data = csr.host("data")
        nnz_per_row = indptr[1:] - indptr[:-1]

        sigma = n_rows if sigma is None else int(sigma)
        order = np.arange(n_rows)
        for w0 in range(0, n_rows, max(sigma, 1)):
            w1 = min(w0 + sigma, n_rows)
            seg = order[w0:w1]
            order[w0:w1] = seg[np.argsort(-nnz_per_row[seg], kind="stable")]

        n_slices = -(-n_rows // c) if n_rows else 0
        cnt = np.zeros(n_slices * c, np.int64)            # entries of each slice row
        cnt[:n_rows] = nnz_per_row[order]
        k = cnt.reshape(n_slices, c).max(axis=1, initial=0)
        offs = np.concatenate([[0], np.cumsum(c * k)]).astype(np.int64)
        total = int(offs[-1])
        slot_rows = np.full(total, n_rows, np.int32)
        slot_cols = np.zeros(total, np.int32)
        slot_vals = np.zeros(total, data.dtype)
        # every entry of slice row p (row order[p]) at slot
        # offs[p // c] + (p % c) * k[p // c] + j, j < its count
        p = np.repeat(np.arange(n_rows, dtype=np.int64), cnt[:n_rows])
        first = np.cumsum(cnt[:n_rows]) - cnt[:n_rows]
        j = np.arange(p.size, dtype=np.int64) - np.repeat(first, cnt[:n_rows])
        s = p // c
        dst = offs[s] + (p % c) * k[s] + j
        src = indptr[order[p]].astype(np.int64) + j
        slot_rows[dst] = order[p]
        slot_cols[dst] = indices[src]
        slot_vals[dst] = data[src]
        host = dict(slot_rows=slot_rows, slot_cols=slot_cols,
                    slice_offsets=offs.astype(np.int32))
        out = cls(slot_vals=to_device(slot_vals, csr.dtype, csr.device),
                  **{f: to_device(a, None, csr.device) for f, a in host.items()},
                  shape=(n_rows, n_cols), slice_height=c)
        return out._stash_host(slot_vals=slot_vals, **host)

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        return COO(rows=self.slot_rows, cols=self.slot_cols, vals=self.slot_vals,
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    def to_ell(self, n_cols_per_row: int | None = None):
        from .ell import ELL

        return ELL.from_csr(self.to_csr(), n_cols_per_row=n_cols_per_row)

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.slot_rows.shape[0])

    @property
    def index_dtype(self):
        return self.slot_cols.dtype

    @property
    def data(self):
        return self.slot_vals

    def n_non_zero_entries(self) -> int:
        return int((self.slot_rows.long() < self.n_rows).sum())

    def scale(self, scalar) -> "SELL":
        return dataclasses.replace(self, slot_vals=self.slot_vals * scalar)

    def padding_ratio(self) -> float:
        """Fraction of slots that are padding."""
        return 1.0 - self.n_non_zero_entries() / max(self.nse, 1)
