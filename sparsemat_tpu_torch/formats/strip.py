"""StripELL — strip-packed window format for bounded-span scattered
matrices (counterpart of ``sparsemat_tpu/formats/strip.py``).

A **strip** is one 128-lane slot row: level ``l`` of window ``w`` in a
128-row block — lane r holds the l-th entry (column order) of row r in the
128-column window w, or padding.  The strips of all of a block's windows
concatenate into one (c_total, 128) tile; ``wrel`` gives each strip's
window relative to the block's group tile base (``wtile · 32`` windows), and
``lidx`` the column within the window, byte-packed ``lidx_pack`` strips per
int32 word (strip s lives in byte s // cp of word row s % cp, with
cp = c_total / lidx_pack).  Groups of ``g4`` consecutive blocks share one
tile base; groups are split into class parts by strip count.

The layout is the JAX package's, array for array and bit for bit (the
freeze below is the same host numpy program), even where the TPU shaped it:
later format conversions and checkpoints compare against it.  Only the
SpMV is redesigned: on the card it walks the matrix's compact row-group
plan, built once from ``to_coo`` (``kernels/_rowgroup.py``,
``csrc/spmv.cu``), and gathers x directly, so the xᵀ tiles the TPU kernel
assembles (``build_xt_tiles``) are kept here for parity only.  The freeze
runs on the host and uploads once; the host arrays stay cached
(``host()``), as ``CSR.from_host_coo`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..types import accum_dtype, as_torch_dtype, host_dtype
from .base import SparseFormat, to_device

RB = 128          # rows per block
WINDOW = 128      # columns per window
TILE_STRIDE = 32  # tile bases are multiples of 32 windows
SUBLANE = 8       # c_total is a multiple of SUBLANE · lidx_pack


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class StripPart(SparseFormat):
    """One class of a StripELL: ``nb`` blocks (groups of ``g4`` consecutive
    blocks share one tile base) with one class-wide ``c_total``.

    ``vals`` (nb, c_total, 128) values; ``lidx`` (nb, c_total/lidx_pack,
    128) int32 packed col-in-window; ``wrel`` (nb, cg, 128) int32 window per
    strip relative to the group's tile base (cg = ceil(c_total/128), tail
    0); ``wtile`` (nb/g4,) int32 tile id per group; ``occ`` (nb, c_total,
    128) bool stored-entry mask (tells stored zeros from padding; read once,
    by ``to_coo``, where the row-group plan is built); ``block_ids`` the
    original block of each of the nb blocks (ids ≥ the number of row blocks
    are the trailing group pad).
    """

    vals: torch.Tensor
    lidx: torch.Tensor
    wrel: torch.Tensor
    wtile: torch.Tensor
    occ: torch.Tensor
    block_ids: Tuple[int, ...]
    shape: Tuple[int, int]
    g4: int = 1
    lidx_pack: int = 1

    @property
    def c_total(self) -> int:
        return int(self.vals.shape[1])

    @property
    def n_blocks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def data(self):
        return self.vals

    @property
    def index_dtype(self):
        return torch.int32

    @property
    def nse(self) -> int:
        return int(self.vals.numel())

    def n_non_zero_entries(self) -> int:
        return int(self.occ.sum())

    def scale(self, scalar) -> "StripPart":
        return dataclasses.replace(self, vals=self.vals * scalar)

    def lidx_unpacked(self) -> torch.Tensor:
        """(nb, c_total, 128) int32 col-in-window (unpacks ``lidx``)."""
        if self.lidx_pack == 1:
            return self.lidx.to(torch.int32)
        parts = [(self.lidx >> (8 * k)) & 0xFF for k in range(self.lidx_pack)]
        return torch.cat(parts, dim=1)[:, : self.c_total]

    def abs_windows(self) -> torch.Tensor:
        """(nb, c_total) int32 absolute window per strip."""
        nb, c, _ = self.vals.shape
        wr = self.wrel.reshape(nb, -1)[:, :c].to(torch.int32)
        wt_blk = torch.repeat_interleave(self.wtile.to(torch.int32), self.g4)[:nb]
        return wt_blk[:, None] * TILE_STRIDE + wr

    def to_coo(self):
        from .coo import COO

        nb, c, rb = self.vals.shape
        n_rows = self.shape[0]
        dev = self.vals.device
        cols = self.abs_windows()[:, :, None] * WINDOW + self.lidx_unpacked()
        ids = torch.tensor(self.block_ids, dtype=torch.int32, device=dev)
        rows = ids[:, None, None] * RB + torch.arange(rb, dtype=torch.int32, device=dev)
        rows = rows.expand(nb, c, rb).reshape(-1)
        stored = self.occ.reshape(-1)
        return COO(rows=torch.where(stored, rows, n_rows),
                   cols=torch.where(stored, cols.reshape(-1), 0),
                   vals=torch.where(stored, self.vals.reshape(-1), 0),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class StripELL(SparseFormat):
    """Strip-packed window format: class parts + static block recombination."""

    parts: Tuple[StripPart, ...]
    shape: Tuple[int, int]

    @classmethod
    def from_csr(cls, csr, n_classes: int = 32, group: int = 16,
                 lidx_pack: int = 4) -> "StripELL":
        """Host-side freeze (the JAX package's, step for step).  ``group``
        consecutive blocks share one tile base; classes are histograms over
        groups keyed by the group's max per-block strip count; ``lidx_pack``
        strips share each lidx int32 word.  Raises ``ValueError`` where a
        group's windows span ≥ 128 windows from its tile base, where a
        (row, window) holds more than 64 entries, and on a ``lidx_pack``
        other than 1, 2 or 4."""
        n_rows, n_cols = csr.shape
        dev = csr.device
        tdt = csr.dtype
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        n_rb = max(-(-n_rows // RB), 1)
        group = int(np.clip(group, 1, n_rb))
        n_grp = -(-n_rb // group)
        n_rbp = n_grp * group             # blocks incl. trailing group pad
        if nnz == 0:
            part = _empty_part((n_rows, n_cols), tuple(range(n_rb)), tdt, dev)
            return cls(parts=(part,), shape=(n_rows, n_cols))

        rows = np.repeat(np.arange(n_rows, dtype=np.int64),
                         np.diff(indptr))[:nnz]
        cols = indices[:nnz]
        vals = data[:nnz]
        blk = rows // RB
        lane = rows % RB
        win = cols // WINDOW
        n_win = max(-(-n_cols // WINDOW), 1)

        # per-group tile base; every window of the group must lie within
        # 128 windows of it.  Bases are clamped to the last tile
        # build_xt_tiles makes (tiles overlap: stride 32, width 128).
        egrp = blk // group
        wmin = np.full(n_grp, np.iinfo(np.int64).max)
        wmax = np.full(n_grp, -1, np.int64)
        np.minimum.at(wmin, egrp, win)
        np.maximum.at(wmax, egrp, win)
        has = wmax >= 0
        wmin[~has] = 0
        wmax[~has] = 0
        n_tiles = _n_tiles(n_cols)
        wtile_g = np.minimum(wmin // TILE_STRIDE, n_tiles - 1)
        span = wmax - wtile_g * TILE_STRIDE
        if int(span.max(initial=0)) >= 128:
            raise ValueError(
                f"StripELL needs every {group}-block group's column span "
                f"within one 128-window tile (max relative window "
                f"{int(span.max())} >= 128) — use SlabPack/RouteStream "
                "for wide-scatter matrices, or a smaller ``group``")

        # level = rank of the entry within its (blk, win, lane) group, in
        # column order (CSR rows are column-sorted)
        key = (blk * n_win + win) * RB + lane
        order = np.argsort(key, kind="stable")
        ks = key[order]
        newgrp = np.concatenate([[True], ks[1:] != ks[:-1]])
        gid = np.cumsum(newgrp) - 1
        first_of_grp = np.flatnonzero(newgrp)
        level = np.arange(nnz) - first_of_grp[gid]

        # strip id within block: strips ordered by (win, level)
        bw = ks // RB                        # blk * n_win + win, sorted
        sb = bw // n_win                     # block of each sorted entry
        sw = bw % n_win
        skey = (sb * n_win + sw) * 64 + np.minimum(level, 63)
        uniq, sidx = np.unique(skey, return_inverse=True)
        s_blk = uniq // (n_win * 64)
        s_first = np.searchsorted(s_blk, np.arange(n_rb))
        strip_in_blk = np.arange(uniq.size) - s_first[s_blk]
        n_strips = np.bincount(s_blk.astype(np.int64),
                               minlength=n_rbp).astype(np.int64)
        if int(level.max(initial=0)) > 63:
            raise ValueError("StripELL: >64 entries in one (row, window)")

        # class split over groups by the group's max per-block strip count
        strips_g = n_strips.reshape(n_grp, group).max(axis=1)
        n_classes = int(np.clip(n_classes, 1, n_grp))
        order_g = np.argsort(strips_g, kind="stable")
        chunks = [np.sort(ch) for ch in np.array_split(order_g, n_classes)
                  if ch.size]
        pos_of_blk = np.zeros(n_rbp, np.int64)
        cls_of_blk = np.zeros(n_rbp, np.int64)
        for ci, ch in enumerate(chunks):
            blocks = (ch[:, None] * group + np.arange(group)).ravel()
            pos_of_blk[blocks] = np.arange(blocks.size)
            cls_of_blk[blocks] = ci

        ent_cls = cls_of_blk[sb]
        ent_pos = pos_of_blk[sb]
        lidx_pack = int(lidx_pack)
        if lidx_pack not in (1, 2, 4):
            raise ValueError("lidx_pack must be 1, 2 or 4")
        quant = SUBLANE * lidx_pack
        parts = []
        for ci, ch in enumerate(chunks):
            blocks = (ch[:, None] * group + np.arange(group)).ravel()
            c_total = int(-(-max(int(strips_g[ch].max(initial=0)), 1)
                            // quant) * quant)
            cg = -(-c_total // WINDOW)
            nb = blocks.size
            vals_t = np.zeros((nb, c_total, RB), data.dtype)
            lidx_t = np.zeros((nb, c_total, RB), np.int32)
            occ_t = np.zeros((nb, c_total, RB), bool)
            wrel_t = np.zeros((nb, cg * WINDOW), np.int32)
            sel = ent_cls == ci
            so = order[sel]
            spos = strip_in_blk[sidx[sel]]
            epos = ent_pos[sel]
            elane = lane[so]
            vals_t[epos, spos, elane] = vals[so]
            lidx_t[epos, spos, elane] = (cols[so] % WINDOW).astype(np.int32)
            occ_t[epos, spos, elane] = True
            # per-strip window relative to the strip's group tile base
            ssel = cls_of_blk[s_blk] == ci
            sp = strip_in_blk[ssel]
            sbp = pos_of_blk[s_blk[ssel]]
            wrel_t[sbp, sp] = ((uniq[ssel] // 64) % n_win
                               - wtile_g[s_blk[ssel] // group] * TILE_STRIDE
                               ).astype(np.int32)
            if lidx_pack > 1:
                cp = c_total // lidx_pack
                packed = lidx_t[:, 0:cp].copy()
                for k in range(1, lidx_pack):
                    packed |= lidx_t[:, k * cp:(k + 1) * cp] << (8 * k)
                lidx_out = packed
            else:
                lidx_out = lidx_t
            host = dict(vals=vals_t, lidx=lidx_out,
                        wrel=wrel_t.reshape(nb, cg, WINDOW),
                        wtile=wtile_g[ch].astype(np.int32), occ=occ_t)
            part = StripPart(
                vals=to_device(vals_t, tdt, dev),
                **{k: to_device(v, None, dev) for k, v in host.items() if k != "vals"},
                block_ids=tuple(int(b) for b in blocks),
                shape=(n_rows, n_cols), g4=group, lidx_pack=lidx_pack)
            parts.append(part._stash_host(**host))
        return cls(parts=tuple(parts), shape=(n_rows, n_cols))

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        coos = [p.to_coo() for p in self.parts]
        return COO(rows=torch.cat([c.rows for c in coos]),
                   cols=torch.cat([c.cols for c in coos]),
                   vals=torch.cat([c.vals for c in coos]),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure ------------------------------------------------------------
    @property
    def nse(self) -> int:
        return sum(p.nse for p in self.parts)

    @property
    def index_dtype(self):
        return torch.int32

    @property
    def data(self):
        return self.parts[0].vals

    def n_non_zero_entries(self) -> int:
        return sum(p.n_non_zero_entries() for p in self.parts)

    def scale(self, scalar) -> "StripELL":
        return dataclasses.replace(
            self, parts=tuple(p.scale(scalar) for p in self.parts))

    def astype(self, dtype) -> "StripELL":
        return dataclasses.replace(
            self, parts=tuple(p.astype(dtype) for p in self.parts))

    def fill_ratio(self) -> float:
        return self.n_non_zero_entries() / max(self.nse, 1)

    def n_xt_tiles(self) -> int:
        return _n_tiles(self.shape[1])

    def spmv_traffic_bytes(self) -> int:
        """The JAX package's layout bytes per SpMV on a TPU: every array its
        kernel reads once (vals, lidx, wrel, wtile), the xᵀ tile build
        ((1 + 2·128/32)·x) and y once.  Kept for parity; the CUDA SpMV
        reads the matrix's row-group plan instead and builds no tiles."""
        total = 0
        for p in self.parts:
            total += p.vals.numel() * p.vals.element_size()
            total += p.lidx.numel() * p.lidx.element_size()
            total += p.wrel.numel() * 4 + p.wtile.numel() * 4
        xb = self.shape[1] * self.dtype.itemsize
        total += xb * (1 + 2 * (WINDOW // TILE_STRIDE))
        total += self.shape[0] * accum_dtype(self.dtype).itemsize
        return int(total)


def _n_tiles(n_cols: int) -> int:
    """xᵀ tiles at 32-window stride needed to cover ``n_cols`` columns."""
    n_win = max(-(-n_cols // WINDOW), 1)
    return max(-(-max(n_win - (WINDOW - TILE_STRIDE), 0) // TILE_STRIDE), 0) + 1


def _empty_part(shape, block_ids, dtype, device=None) -> StripPart:
    nb = len(block_ids)
    host = dict(vals=np.zeros((nb, SUBLANE, RB), host_dtype(dtype)),
                lidx=np.zeros((nb, SUBLANE, RB), np.int32),
                wrel=np.zeros((nb, 1, WINDOW), np.int32),
                wtile=np.zeros((nb,), np.int32),
                occ=np.zeros((nb, SUBLANE, RB), bool))
    part = StripPart(vals=to_device(host["vals"], as_torch_dtype(dtype), device),
                     **{k: to_device(v, None, device) for k, v in host.items()
                        if k != "vals"},
                     block_ids=tuple(block_ids), shape=tuple(shape))
    return part._stash_host(**host)


def build_xt_tiles(x: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(n_tiles, 128, 128) transposed x tiles at 32-window stride:
    tiles[t, r, j] = x[(32·t + j)·128 + r] (zero-padded) — the TPU kernel's
    x assembly, kept for parity; the CUDA kernel gathers x directly."""
    n_tiles = _n_tiles(n_cols)
    need = (TILE_STRIDE * (n_tiles - 1) + WINDOW) * WINDOW
    xp = F.pad(x, (0, need - x.shape[0])).reshape(-1, WINDOW)
    starts = torch.arange(n_tiles, device=x.device) * TILE_STRIDE
    rows = starts[:, None] + torch.arange(WINDOW, device=x.device)[None, :]
    return xp[rows].transpose(1, 2)
