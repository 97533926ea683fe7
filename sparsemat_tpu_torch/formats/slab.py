"""SlabELL, SlabPack and SlabStream — slab-windowed, window-bucketed ELL for
scattered rows of bounded column span (counterpart of
``sparsemat_tpu/formats/slab.py``).

A **SlabELL** cuts the rows into blocks of ``rb`` (a multiple of 128).  The
entries of a block are regrouped by the 128-column window they fall in,
relative to the block's first window ``win_lo``: window w of the slab owns
the slots ``[offset, offset + height)`` of the block's C axis (``buckets``,
one static (offset, height) pair per window, heights the global max rank
rounded to 8).  ``vals``/``lidx`` are (n_rb, C, rb) transposed tiles, the
row within the block on the last axis; ``lidx`` is the column within the
slot's window.  ``bucket_cnt`` (n_rb, S, rb) counts the stored entries per
(block, window, row): a bucket's ranks fill from 0, so rank < count marks a
stored entry (stored zeros survive a round trip).

A **SlabPack** splits the row blocks into classes by their padded slot
count; each class is a SlabELL part padded to the class max, ``block_ids``
maps each part's blocks to the global ones, and each part's bucket heights
are lowered where the spilled entries cost less than the padding they
save.  The spilled entries are refrozen exactly (no further spilling) into
``overflow``, itself a SlabPack at rb 128, whose product is added back.

A **SlabStream** stores each (row block, window) bucket at its exact height
rounded to 8, cut into (8 × rb) chunks that form one flat stream tagged
with each chunk's window and row block.

The layout is the JAX package's, array for array and bit for bit (the
freeze below is the same host numpy program, uploaded once at the end, its
host arrays cached).  Only the kernels are redesigned: the SpMV and SpMM
of all three walk the matrix's compact row-group plan, built once from
``to_coo`` (``kernels/_rowgroup.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..types import accum_dtype, host_dtype
from .base import SparseFormat, to_device

SLAB_ROW_BLOCK = 256
WINDOW = 128
SUBLANE = 8
#: padded slots one spilled entry is costed at in the overflow refreeze (the
#: JAX package's measured constant, kept so the layouts stay equal)
_SPILL_SLOT_COST = 67


def _entries(csr):
    """Host (indptr, indices, data, nnz) of a CSR's valid entries, indices
    as int64."""
    indptr = csr.host("indptr").astype(np.int64)
    nnz = int(indptr[-1])
    return indptr, csr.host("indices")[:nnz].astype(np.int64), csr.host("data")[:nnz], nnz


def _ranks(rows, w_rel, nnz):
    """Rank of each entry within its (row, window) run (CSR rows are
    column-sorted, so each run is consecutive)."""
    boundary = np.empty(nnz, bool)
    boundary[0] = True
    boundary[1:] = (rows[1:] != rows[:-1]) | (w_rel[1:] != w_rel[:-1])
    idx = np.arange(nnz, dtype=np.int64)
    run_start = idx[boundary]
    return idx - run_start[np.cumsum(boundary) - 1]


def _slab(host: dict, shape, buckets, dtype, device) -> "SlabELL":
    """A SlabELL from host arrays (vals, lidx, win_lo, bucket_cnt): one
    upload each, host arrays cached."""
    part = SlabELL(vals=to_device(host["vals"], dtype, device),
                   **{k: to_device(v, None, device) for k, v in host.items() if k != "vals"},
                   shape=tuple(shape), buckets=tuple(buckets))
    return part._stash_host(**host)


def _empty_slab_host(n_rb: int, rb: int, dtype) -> dict:
    return dict(vals=np.zeros((n_rb, SUBLANE, rb), host_dtype(dtype)),
                lidx=np.zeros((n_rb, SUBLANE, rb), np.int32),
                win_lo=np.zeros((n_rb,), np.int32),
                bucket_cnt=np.zeros((n_rb, 1, rb), np.int32))


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class SlabELL(SparseFormat):
    """Frozen slab-windowed matrix: ``vals``/``lidx`` (n_rb, C, rb),
    ``win_lo`` (n_rb,), ``bucket_cnt`` (n_rb, S, rb) or None (then a
    nonzero value marks a stored entry), ``buckets`` ((offset, height), ...)
    per slab window."""

    _spmv_read_fields = ("vals", "lidx", "win_lo")  # bucket_cnt: round trips only

    vals: torch.Tensor
    lidx: torch.Tensor
    win_lo: torch.Tensor
    bucket_cnt: Optional[torch.Tensor]
    shape: Tuple[int, int]
    buckets: Tuple[Tuple[int, int], ...]

    @classmethod
    def from_csr(cls, csr, rb: int = SLAB_ROW_BLOCK) -> "SlabELL":
        """Host freeze.  ``rb`` must be a multiple of 128; the CSR's rows
        column-sorted (canonical CSR is)."""
        if rb % WINDOW:
            raise ValueError(f"rb must be a multiple of {WINDOW}, got {rb}")
        n_rows, n_cols = csr.shape
        indptr, indices, data, nnz = _entries(csr)
        n_rb = max(-(-n_rows // rb), 1)
        if nnz == 0:
            return _slab(_empty_slab_host(n_rb, rb, csr.dtype), (n_rows, n_cols),
                         ((0, SUBLANE),), csr.dtype, csr.device)

        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        blk = rows // rb
        lrow = (rows % rb).astype(np.int64)
        win = indices // WINDOW

        lo = np.full(n_rb, np.iinfo(np.int64).max)
        np.minimum.at(lo, blk, win)
        hi = np.zeros(n_rb, np.int64)
        np.maximum.at(hi, blk, win)
        lo[lo == np.iinfo(np.int64).max] = 0
        s = int((hi - lo).max(initial=0)) + 1

        w_rel = win - lo[blk]
        rank = _ranks(rows, w_rel, nnz)
        heights = np.zeros(s, np.int64)
        np.maximum.at(heights, w_rel, rank + 1)
        heights = -(-heights // SUBLANE) * SUBLANE
        heights = np.maximum(heights, SUBLANE)
        offs = np.concatenate([[0], np.cumsum(heights)])
        c_total = int(offs[-1])

        vals_t = np.zeros((n_rb, c_total, rb), data.dtype)
        lidx_t = np.zeros((n_rb, c_total, rb), np.int32)
        cpos = offs[w_rel] + rank
        vals_t[blk, cpos, lrow] = data
        lidx_t[blk, cpos, lrow] = (indices % WINDOW).astype(np.int32)
        cnt = np.zeros((n_rb, s, rb), np.int32)
        np.add.at(cnt, (blk, w_rel, lrow), 1)
        buckets = tuple((int(offs[w]), int(heights[w])) for w in range(s))
        host = dict(vals=vals_t, lidx=lidx_t, win_lo=lo.astype(np.int32), bucket_cnt=cnt)
        return _slab(host, (n_rows, n_cols), buckets, csr.dtype, csr.device)

    # -- canonical views ------------------------------------------------------
    def _window_of_cpos(self) -> np.ndarray:
        """(C,) slab-window id of each C-axis slot (static)."""
        w_of = np.zeros(self.c_total, np.int32)
        for w, (o, h) in enumerate(self.buckets):
            w_of[o:o + h] = w
        return w_of

    def _stored_mask(self) -> torch.Tensor:
        """(n_rb, C, rb) bool: the slot holds a stored entry (stored zeros
        included) rather than bucket padding."""
        if self.bucket_cnt is None:
            return self.vals != 0
        dev = self.vals.device
        w_of = self._window_of_cpos()
        offs = np.array([o for o, _ in self.buckets], np.int32)
        rank_c = torch.from_numpy(np.arange(self.c_total, dtype=np.int32)
                                  - offs[w_of]).to(dev)
        cnt_c = self.bucket_cnt[:, torch.from_numpy(w_of).long().to(dev), :]
        return rank_c[None, :, None] < cnt_c

    def to_coo(self):
        from .coo import COO

        n_rb, _, rb = self.vals.shape
        dev = self.vals.device
        w_of = torch.from_numpy(self._window_of_cpos()).to(dev)
        cols = (self.lidx.to(torch.int32)
                + (self.win_lo[:, None, None] + w_of[None, :, None]) * WINDOW)
        rows = (torch.arange(n_rb, dtype=torch.int32, device=dev)[:, None, None] * rb
                + torch.arange(rb, dtype=torch.int32, device=dev)[None, None, :])
        rows = rows.expand(self.vals.shape).reshape(-1)
        stored = self._stored_mask().reshape(-1)
        return COO(rows=torch.where(stored, rows, self.shape[0]),
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
    def row_block(self) -> int:
        return int(self.vals.shape[2])

    @property
    def n_row_blocks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def c_total(self) -> int:
        return int(self.vals.shape[1])

    @property
    def slab_windows(self) -> int:
        return len(self.buckets)

    @property
    def index_dtype(self):
        return torch.int32

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self) -> int:
        if self.bucket_cnt is not None:
            return int(self.bucket_cnt.sum())
        return int(torch.count_nonzero(self.vals))

    def scale(self, scalar) -> "SlabELL":
        return dataclasses.replace(self, vals=self.vals * scalar)

    def fill_ratio(self) -> float:
        return self.n_non_zero_entries() / max(self.nse, 1)

    def x_windows(self) -> int:
        """Windows of the operand incl. the slab's overrun slack (the JAX
        package pads x to this; the CUDA kernel bounds-checks instead)."""
        return -(-self.shape[1] // WINDOW) + self.slab_windows

    def x_bytes(self, itemsize: int = 4) -> int:
        return self.x_windows() * WINDOW * itemsize


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class SlabPack(SparseFormat):
    """SlabELL parts with per-class bucket heights, plus the spilled
    entries as an exact ``overflow`` SlabPack at rb 128 (or None).
    ``parts[i]`` covers the global row blocks ``block_ids[i]`` (ascending);
    every global block is in exactly one part."""

    parts: Tuple[SlabELL, ...]
    block_ids: Tuple[Tuple[int, ...], ...]
    shape: Tuple[int, int]
    row_block: int
    overflow: Optional["SlabPack"] = None

    @classmethod
    def from_csr(cls, csr, rb: int = SLAB_ROW_BLOCK, n_classes: int = 8,
                 spill_frac: float = 0.02) -> "SlabPack":
        """Host freeze with per-class bucket heights (the JAX package's,
        step for step).  Blocks are sorted by their exact padded slot count
        and split into ``n_classes`` equal-count classes; each class's
        window heights are the max over its members, lowered (when
        ``spill_frac > 0``) to the 8-multiple that minimises padded slots
        plus spilled entries at ``_SPILL_SLOT_COST`` each."""
        if rb % WINDOW:
            raise ValueError(f"rb must be a multiple of {WINDOW}, got {rb}")
        n_rows, n_cols = csr.shape
        dev, tdt = csr.device, csr.dtype
        indptr, indices, data, nnz = _entries(csr)
        n_rb = max(-(-n_rows // rb), 1)
        if nnz == 0:
            part = _slab(_empty_slab_host(n_rb, rb, tdt), (n_rb * rb, n_cols),
                         ((0, SUBLANE),), tdt, dev)
            return cls(parts=(part,), block_ids=(tuple(range(n_rb)),),
                       shape=(n_rows, n_cols), row_block=rb)

        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        blk = rows // rb
        lrow = (rows % rb).astype(np.int64)
        win = indices // WINDOW

        lo = np.full(n_rb, np.iinfo(np.int64).max)
        np.minimum.at(lo, blk, win)
        hi = np.zeros(n_rb, np.int64)
        np.maximum.at(hi, blk, win)
        empty = lo == np.iinfo(np.int64).max
        lo[empty] = 0
        hi[empty] = 0
        span = hi - lo + 1
        s_max = int(span.max(initial=1))

        w_rel = win - lo[blk]
        rank = _ranks(rows, w_rel, nnz)
        H = np.zeros((n_rb, s_max), np.int64)
        np.maximum.at(H, (blk, w_rel), rank + 1)
        H8 = -(-H // SUBLANE) * SUBLANE
        c_exact = H8.sum(axis=1)

        n_classes = int(np.clip(n_classes, 1, n_rb))
        order = np.argsort(c_exact, kind="stable")
        chunks = [np.sort(ch) for ch in np.array_split(order, n_classes) if ch.size]

        eorder = np.argsort(blk, kind="stable")
        blk_sorted = blk[eorder]
        blk_starts = np.searchsorted(blk_sorted, np.arange(n_rb + 1))

        parts, ids, spills = [], [], []
        for members in chunks:
            sel = np.concatenate(
                [eorder[blk_starts[b]:blk_starts[b + 1]] for b in members]
            ) if members.size else np.zeros(0, np.int64)
            Hc = H8[members].max(axis=0) if members.size else np.zeros(1, np.int64)
            s_c = max(int(np.nonzero(Hc)[0].max(initial=0)) + 1, 1)
            heights = Hc[:s_c].copy()
            nb_c = len(members)
            if spill_frac > 0 and sel.size:
                ew_all = w_rel[sel]
                rmax = int(rank[sel].max(initial=0))
                hist = np.zeros((s_c, rmax + 2), np.int64)
                np.add.at(hist, (ew_all, rank[sel]), 1)
                above = hist[:, ::-1].cumsum(axis=1)[:, ::-1]   # (s_c, r): # rank >= r
                cand = np.arange(0, -(-(rmax + 1) // SUBLANE) * SUBLANE + 1, SUBLANE)
                cand_sp = above[:, np.minimum(cand, rmax + 1)]
                cost = cand[None, :] * (nb_c * rb) + cand_sp * _SPILL_SLOT_COST
                pick = cand[np.argmin(cost, axis=1)]
                heights = np.minimum(heights, pick)
                spill_e = sel[rank[sel] >= heights[ew_all]]
                if spill_e.size:
                    spills.append(spill_e)
                    sel = sel[rank[sel] < heights[ew_all]]
            if heights.sum() == 0:
                heights = np.array([SUBLANE], np.int64)
                s_c = 1
            else:
                s_c = max(int(np.nonzero(heights)[0].max(initial=0)) + 1, 1)
                heights = heights[:s_c]
            offs = np.concatenate([[0], np.cumsum(heights)])
            c_total = int(offs[-1])
            lb_of = np.full(n_rb, -1, np.int64)
            lb_of[members] = np.arange(nb_c)

            vals_t = np.zeros((nb_c, c_total, rb), data.dtype)
            lidx_t = np.zeros((nb_c, c_total, rb), np.int32)
            cnt = np.zeros((nb_c, s_c, rb), np.int32)
            if sel.size:
                eb = lb_of[blk[sel]]
                ew = w_rel[sel]
                cpos = offs[ew] + rank[sel]
                vals_t[eb, cpos, lrow[sel]] = data[sel]
                lidx_t[eb, cpos, lrow[sel]] = (indices[sel] % WINDOW).astype(np.int32)
                np.add.at(cnt, (eb, ew, lrow[sel]), 1)
            buckets = tuple((int(offs[w]), int(heights[w])) for w in range(s_c))
            host = dict(vals=vals_t, lidx=lidx_t, win_lo=lo[members].astype(np.int32),
                        bucket_cnt=cnt)
            parts.append(_slab(host, (nb_c * rb, n_cols), buckets, tdt, dev))
            ids.append(tuple(int(b) for b in members))

        overflow = None
        if spills:
            sp = np.concatenate(spills)
            overflow = cls._freeze_entries(rows[sp], indices[sp], data[sp],
                                           (n_rows, n_cols), tdt, dev)
        return cls(parts=tuple(parts), block_ids=tuple(ids),
                   shape=(n_rows, n_cols), row_block=rb, overflow=overflow)

    @classmethod
    def _freeze_entries(cls, erows, ecols, evals, shape, dtype, device):
        """Exact (spill_frac = 0) refreeze of loose (unique) triplets through
        a host CSR, at rb 128 with 16 classes."""
        from .csr import CSR

        csr = CSR.from_host_coo(erows, ecols, evals, shape, dtype=dtype, device=device)
        return cls.from_csr(csr, rb=WINDOW, n_classes=16, spill_frac=0.0)

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        rb = self.row_block
        n_rows = self.shape[0]
        rs, cs, vs = [], [], []
        for part, ids in zip(self.parts, self.block_ids):
            pc = part.to_coo()
            ids_t = torch.tensor(ids, dtype=torch.int64, device=pc.rows.device)
            prow = pc.rows.long()
            valid = prow < part.shape[0]
            gb = torch.clamp(prow // rb, 0, len(ids) - 1)
            gr = ids_t[gb] * rb + prow % rb
            ok = valid & (gr < n_rows)
            rs.append(torch.where(ok, gr, n_rows).to(torch.int32))
            cs.append(torch.where(ok, pc.cols, 0))
            vs.append(torch.where(ok, pc.vals, 0))
        if self.overflow is not None:
            oc = self.overflow.to_coo()
            rs.append(oc.rows.to(torch.int32))
            cs.append(oc.cols)
            vs.append(oc.vals)
        return COO(rows=torch.cat(rs), cols=torch.cat(cs), vals=torch.cat(vs),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        n = sum(p.nse for p in self.parts)
        return n + (self.overflow.nse if self.overflow is not None else 0)

    @property
    def index_dtype(self):
        return torch.int32

    @property
    def data(self):
        return self.parts[0].vals

    @property
    def n_row_blocks(self) -> int:
        return sum(len(ids) for ids in self.block_ids)

    def n_non_zero_entries(self) -> int:
        n = sum(p.n_non_zero_entries() for p in self.parts)
        if self.overflow is not None:
            n += self.overflow.n_non_zero_entries()
        return n

    def scale(self, scalar) -> "SlabPack":
        return dataclasses.replace(
            self, parts=tuple(p.scale(scalar) for p in self.parts),
            overflow=self.overflow.scale(scalar) if self.overflow is not None else None)

    def astype(self, dtype) -> "SlabPack":
        return dataclasses.replace(
            self, parts=tuple(p.astype(dtype) for p in self.parts),
            overflow=self.overflow.astype(dtype) if self.overflow is not None else None)

    def fill_ratio(self) -> float:
        return self.n_non_zero_entries() / max(self.nse, 1)

    def x_bytes(self, itemsize: int = 4) -> int:
        b = max(p.x_bytes(itemsize) for p in self.parts)
        if self.overflow is not None:
            b = max(b, self.overflow.x_bytes(itemsize))
        return b

    def max_part_tile_bytes(self) -> int:
        """Largest per-part (C, rb) tile pair in bytes (the JAX package's
        VMEM dispatch guard; nothing in the port bounds by it)."""
        b = max(p.c_total * p.row_block * 8 for p in self.parts)
        if self.overflow is not None:
            b = max(b, self.overflow.max_part_tile_bytes())
        return b

    def spmv_traffic_bytes(self) -> int:
        """The layout's bytes per SpMV (the JAX package's count): every
        part's vals, lidx and win_lo once, the overflow's own count without
        its x and y, then one x read and one y write."""
        total = 0
        for p in self.parts:
            for name in p._spmv_read_fields:
                arr = getattr(p, name)
                total += arr.numel() * arr.element_size()
        xb = self.shape[1] * self.dtype.itemsize
        yb = self.shape[0] * accum_dtype(self.dtype).itemsize
        if self.overflow is not None:
            total += self.overflow.spmv_traffic_bytes() - xb - yb
        return int(total + xb + yb)


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class SlabStream(SparseFormat):
    """The slab layout as one flat stream of (8 × rb) chunks: each (row
    block, window) bucket at its exact height rounded to 8, cut into
    8-sublane chunks.  ``vals``/``lidx`` (N, 8, rb), ``lidx`` the column
    within the chunk's window; ``win_id``/``blk_id`` (N,) int32 window and
    row block per chunk (chunks in (block, window) order); ``cnt8`` (N, rb)
    int32 stored entries per (chunk, row): sublane < count marks a stored
    entry.  The nnz = 0 layout is one zero chunk."""

    # the JAX package's count; cnt8 is read by to_coo only (round trips, plan builds)
    _spmv_read_fields = ("vals", "lidx", "win_id", "blk_id")

    vals: torch.Tensor
    lidx: torch.Tensor
    win_id: torch.Tensor
    blk_id: torch.Tensor
    cnt8: torch.Tensor
    shape: Tuple[int, int]
    row_block: int

    @classmethod
    def from_csr(cls, csr, rb: int = SLAB_ROW_BLOCK) -> "SlabStream":
        """Host freeze (the JAX package's, step for step).  ``rb`` must be a
        multiple of 128; the CSR's rows column-sorted (canonical CSR is)."""
        if rb % WINDOW:
            raise ValueError(f"rb must be a multiple of {WINDOW}, got {rb}")
        n_rows, n_cols = csr.shape
        indptr, indices, data, nnz = _entries(csr)
        n_win = max(-(-n_cols // WINDOW), 1)
        if nnz == 0:
            host = dict(vals=np.zeros((1, SUBLANE, rb), data.dtype),
                        lidx=np.zeros((1, SUBLANE, rb), np.int32),
                        win_id=np.zeros((1,), np.int32), blk_id=np.zeros((1,), np.int32),
                        cnt8=np.zeros((1, rb), np.int32))
            return cls._upload(host, (n_rows, n_cols), rb, csr)

        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        blk = rows // rb
        lrow = (rows % rb).astype(np.int64)
        win = indices // WINDOW
        rank = _ranks(rows, win, nnz)

        # (block, window) buckets at exact 8-rounded heights → chunk stream
        key = blk * n_win + win
        ukey, key_inv = np.unique(key, return_inverse=True)
        hmax = np.zeros(ukey.shape[0], np.int64)
        np.maximum.at(hmax, key_inv, rank + 1)
        n_chunks_per = -(-hmax // SUBLANE)
        chunk_start = np.concatenate([[0], np.cumsum(n_chunks_per)])
        n_chunks = int(chunk_start[-1])

        vals_t = np.zeros((n_chunks, SUBLANE, rb), data.dtype)
        lidx_t = np.zeros((n_chunks, SUBLANE, rb), np.int32)
        ch = chunk_start[key_inv] + rank // SUBLANE
        sub = rank % SUBLANE
        vals_t[ch, sub, lrow] = data
        lidx_t[ch, sub, lrow] = (indices % WINDOW).astype(np.int32)

        # per-(bucket, row) counts → per-chunk counts clipped to 8
        kcnt = np.zeros((ukey.shape[0], rb), np.int64)
        np.add.at(kcnt, (key_inv, lrow), 1)
        key_of_chunk = np.repeat(np.arange(ukey.shape[0]), n_chunks_per)
        cl = np.arange(n_chunks) - chunk_start[key_of_chunk]
        cnt8 = np.clip(kcnt[key_of_chunk] - SUBLANE * cl[:, None], 0, SUBLANE).astype(np.int32)
        host = dict(vals=vals_t, lidx=lidx_t,
                    win_id=(ukey % n_win)[key_of_chunk].astype(np.int32),
                    blk_id=(ukey // n_win)[key_of_chunk].astype(np.int32), cnt8=cnt8)
        return cls._upload(host, (n_rows, n_cols), rb, csr)

    @classmethod
    def _upload(cls, host: dict, shape, rb: int, csr) -> "SlabStream":
        out = cls(vals=to_device(host["vals"], csr.dtype, csr.device),
                  **{k: to_device(v, None, csr.device) for k, v in host.items() if k != "vals"},
                  shape=tuple(shape), row_block=rb)
        return out._stash_host(**host)

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows = self.shape[0]
        rb = self.row_block
        dev = self.vals.device
        sub = torch.arange(SUBLANE, dtype=torch.int32, device=dev)
        lane = torch.arange(rb, dtype=torch.int32, device=dev)
        stored = sub[None, :, None] < self.cnt8[:, None, :]
        rows = (self.blk_id[:, None, None] * rb + lane[None, None, :]).expand(self.vals.shape)
        cols = self.win_id[:, None, None] * WINDOW + self.lidx.to(torch.int32)
        ok = stored & (rows < n_rows)
        return COO(rows=torch.where(ok, rows, n_rows).reshape(-1),
                   cols=torch.where(ok, cols, 0).reshape(-1),
                   vals=torch.where(ok, self.vals, 0).reshape(-1),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.vals.numel())

    @property
    def n_chunks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_row_blocks(self) -> int:
        return max(-(-self.shape[0] // self.row_block), 1)

    @property
    def index_dtype(self):
        return torch.int32

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self) -> int:
        return int(self.cnt8.sum())

    def scale(self, scalar) -> "SlabStream":
        return dataclasses.replace(self, vals=self.vals * scalar)

    def fill_ratio(self) -> float:
        return self.n_non_zero_entries() / max(self.nse, 1)

    def x_windows(self) -> int:
        return max(-(-self.shape[1] // WINDOW), 1)
