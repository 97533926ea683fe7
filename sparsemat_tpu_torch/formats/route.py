"""RouteStream — statically routed product stream for *globally scattered*
matrices, the circuit-simulation regime (counterpart of
``sparsemat_tpu/formats/route.py``).

Every routing decision is made at freeze time.  Entries are sorted by
column window and packed into 128-entry *A-rows* (one x window per row);
128 A-rows form a *supertile*.  Kernel 1 (gather) multiplies each slot by
its x value and routes every product to its own *staging* slot through the
tables ``p1``/``m1``/``p2``/``p3`` and the staging rows ``touch`` of each
(supertile, split).  Staging is laid out so that each 128-lane row holds
whole matrix-row segments of ONE output window, in CSR order; 128 staging
rows form a *region*.  Kernel 2 (reduce) permutes each region from arrival
order to that reduce layout (``q1``/``q2``/``q3``) and sums each segment
(``lpos``/``ppos``/``pmask``/``segmask``) into the y window ``wrow``.

The layout is the JAX package's, array for array and bit for bit (the
freeze below is the same host numpy program), even where the TPU shaped it:
the 3-phase tables (lane gather, transpose, lane gather, transpose, lane
gather) exist because a TPU has no sublane gather, and a GPU thread composes
them into one gather (``csrc/route.cu``).  The freeze runs on the host and
uploads once; the host arrays stay cached (``host()``), as
``CSR.from_host_coo`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import SparseFormat, to_device

LANE = 128
SUP_ROWS = 128          # A-rows per supertile (one 128×128 routing unit)
REG_ROWS = 128          # staging rows per region (one 128×128 reduce unit)

#: the layout's arrays, in the JAX package's field order
ARRAYS = ("a_vals", "a_lidx", "a_win", "a_rows", "p1", "m1", "p2", "p3", "touch",
          "q1", "q2", "q3", "lpos", "ppos", "pmask", "segmask", "wrow")
#: arrays whose dtype follows the values (the rest are int32)
FLOAT_ARRAYS = ("a_vals", "m1", "pmask", "segmask")


# --- freeze-time helpers -------------------------------------------------------

def _euler_color_128(inst: np.ndarray, src: np.ndarray, dst: np.ndarray,
                     bits: int = 7) -> np.ndarray:
    """Proper 128-edge-colouring of a batch of 128-regular bipartite
    multigraphs: per-edge instance id ``inst`` and endpoints ``src``/``dst``
    (every (inst, src) and (inst, dst) has degree 2**bits).  Returns colours
    in [0, 2**bits) such that no two edges of one instance that share an
    endpoint share a colour.

    Recursive Euler halving: at each level, pair consecutive edges of one
    (instance, colour prefix, endpoint) on both sides; the pairings form
    disjoint even cycles, and 2-colouring each cycle (orbit labels from
    scipy's connected components over the two-step permutation) halves every
    endpoint's degree.  ``bits`` levels give the full colouring."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    e = src.shape[0]
    if e == 0:
        return np.zeros(0, np.int64)
    inst = inst.astype(np.int64)
    src32 = src.astype(np.int32)
    dst32 = dst.astype(np.int32)
    color = np.zeros(e, np.int32)
    indptr = np.arange(e + 1, dtype=np.int64)
    ones = np.ones(e, np.int8)
    for level in range(bits):
        def partners(endpoint):
            key = (inst * (1 << level) + color) * 128 + endpoint
            order = np.argsort(key, kind="stable").astype(np.int32)
            p = np.empty(e, np.int32)
            a = order.reshape(-1, 2)
            p[a[:, 0]] = a[:, 1]
            p[a[:, 1]] = a[:, 0]
            return p

        sp = partners(src32)
        dp = partners(dst32)
        # the two-step map sp∘dp splits each cycle into two orbits; dp links them
        g = sp[dp]
        adj = csr_matrix((ones, g, indptr), shape=(e, e))
        _, orbit = connected_components(adj, directed=False)
        bit = orbit > orbit[dp]
        color = color * 2 + bit
    return color.astype(np.int64)


def _pack_rows_128(keys: np.ndarray):
    """Pack entries (sorted by ``keys``) into 128-lane rows, starting a new
    row whenever the key changes or the row is full.  Returns
    (row_of_entry, lane_of_entry, n_rows)."""
    n = keys.shape[0]
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    new_key = np.empty(n, bool)
    new_key[0] = True
    new_key[1:] = keys[1:] != keys[:-1]
    gid = np.cumsum(new_key) - 1
    starts = np.nonzero(new_key)[0]
    within = np.arange(n) - starts[gid]
    rows_before = np.concatenate([[0], np.cumsum(-(-np.diff(
        np.concatenate([starts, [n]])) // LANE))])
    row = rows_before[gid] + within // LANE
    lane = within % LANE
    return row, lane, int(rows_before[-1])


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class RouteStream(SparseFormat):
    """Frozen statically routed product stream (host-built).

    Per A-row: ``a_vals``/``a_lidx`` (n_sup·128, 128) values and column in
    window, ``a_win`` (n_sup·128,) the x window; ``a_rows`` the matrix row
    of each slot (n_rows for padding), for the canonical views only.
    Kernel 1: ``p1``/``m1``/``p2``/``p3`` (n_sup, n_splits, 128, 128) and
    ``touch`` (n_sup, n_splits, 128).  Kernel 2: ``q1``/``q2``/``q3``/
    ``lpos``/``ppos``/``pmask``/``segmask`` (n_regions, 128, 128) and
    ``wrow`` (n_regions, 128), whose value n_ywin marks an unused row.
    Stored zeros are kept (their slots route like any other)."""

    _spmv_read_fields = tuple(a for a in ARRAYS if a != "a_rows")  # a_rows: canonical views only

    a_vals: torch.Tensor
    a_lidx: torch.Tensor
    a_win: torch.Tensor
    a_rows: torch.Tensor
    p1: torch.Tensor
    m1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    touch: torch.Tensor
    q1: torch.Tensor
    q2: torch.Tensor
    q3: torch.Tensor
    lpos: torch.Tensor
    ppos: torch.Tensor
    pmask: torch.Tensor
    segmask: torch.Tensor
    wrow: torch.Tensor
    shape: Tuple[int, int]

    @classmethod
    def from_host(cls, arrays: dict, shape, dtype=None, device=None) -> "RouteStream":
        """From the 17 host arrays (name → numpy): one upload, host copies
        cached.  ``dtype`` (the values' torch dtype) overrides the host
        dtype of the float arrays (bf16 stages in f32 on the host)."""
        t = {k: to_device(arrays[k], dtype if k in FLOAT_ARRAYS else None, device)
             for k in ARRAYS}
        rs = cls(**t, shape=tuple(int(s) for s in shape))
        return rs._stash_host(**{k: arrays[k] for k in ARRAYS})

    @classmethod
    def from_csr(cls, csr) -> "RouteStream":
        """Host-side freeze (the JAX package's, step for step)."""
        n_rows, n_cols = csr.shape
        tdt = csr.dtype
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        n_ywin = max(-(-n_rows // LANE), 1)

        def done(**arrays):
            return cls.from_host(arrays, (n_rows, n_cols), tdt, csr.device)

        if nnz == 0:
            zf = np.zeros((1, LANE, LANE), data.dtype)
            zi = np.zeros((1, LANE, LANE), np.int32)
            return done(
                a_vals=np.zeros((SUP_ROWS, LANE), data.dtype),
                a_lidx=np.zeros((SUP_ROWS, LANE), np.int32),
                a_win=np.zeros((SUP_ROWS,), np.int32),
                a_rows=np.full((SUP_ROWS, LANE), n_rows, np.int32),
                p1=zi[None], m1=zf[None], p2=zi[None], p3=zi[None],
                touch=np.zeros((1, 1, LANE), np.int32),
                q1=zi, q2=zi, q3=zi, lpos=zi, ppos=zi, pmask=zf, segmask=zf,
                wrow=np.full((1, LANE), n_ywin, np.int32))

        counts = np.diff(indptr)
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
        cols = indices[:nnz]
        vals = data[:nnz]

        # ---- [A] reduce-layout packing (entries in CSR order) ---------------
        # staging rows hold whole matrix-row segments of ONE output window;
        # matrix rows with >128 entries split into full chunks
        ywin = rows // LANE
        within_row = np.arange(nnz) - indptr[rows]
        chunk = within_row // LANE
        seg_new = np.empty(nnz, bool)
        seg_new[0] = True
        seg_new[1:] = (rows[1:] != rows[:-1]) | (chunk[1:] != chunk[:-1])
        seg_id = np.cumsum(seg_new) - 1
        seg_sizes = np.bincount(seg_id)
        seg_ywin = ywin[seg_new]
        n_seg = seg_sizes.shape[0]
        # first-fit segments into staging rows per y window (plain Python
        # lists: numpy scalar indexing is ~10× slower per step)
        sizes_l = seg_sizes.tolist()
        ywin_l = seg_ywin.tolist()
        srow_l = [0] * n_seg
        sstart_l = [0] * n_seg
        n_srows = 0
        fill = LANE + 1  # force a new row at k == 0
        prev_w = -1
        for k in range(n_seg):
            sz = sizes_l[k]
            w = ywin_l[k]
            if w != prev_w or fill + sz > LANE:
                n_srows += 1
                fill = 0
                prev_w = w
            srow_l[k] = n_srows - 1
            sstart_l[k] = fill
            fill += sz
        srow_of_seg = np.asarray(srow_l, np.int64)
        sstart_of_seg = np.asarray(sstart_l, np.int64)
        # per-entry reduce slot (CSR order)
        red_srow = srow_of_seg[seg_id]
        red_slane = sstart_of_seg[seg_id] + (within_row % LANE)
        n_reg = max(-(-n_srows // REG_ROWS), 1)
        n_srows_pad = n_reg * REG_ROWS

        # ---- [B] kernel-2 extraction tables ----------------------------------
        lpos = np.zeros((n_reg, REG_ROWS, LANE), np.int32)
        ppos = np.zeros((n_reg, REG_ROWS, LANE), np.int32)
        pmask = np.zeros((n_reg, REG_ROWS, LANE), np.float32)
        segmask = np.zeros((n_reg, REG_ROWS, LANE), np.float32)
        wrow = np.full((n_reg, REG_ROWS), n_ywin, np.int32)  # unused-row value
        seg_end = sstart_of_seg + seg_sizes - 1
        seg_row_mod = (rows[seg_new] % LANE).astype(np.int64)
        reg_s = srow_of_seg // REG_ROWS
        rloc_s = srow_of_seg % REG_ROWS
        lpos[reg_s, rloc_s, seg_row_mod] = seg_end.astype(np.int32)
        has_prev = sstart_of_seg > 0
        ppos[reg_s[has_prev], rloc_s[has_prev], seg_row_mod[has_prev]] = (
            sstart_of_seg[has_prev] - 1).astype(np.int32)
        pmask[reg_s[has_prev], rloc_s[has_prev], seg_row_mod[has_prev]] = 1.0
        segmask[reg_s, rloc_s, seg_row_mod] = 1.0
        wrow[reg_s, rloc_s] = seg_ywin.astype(np.int32)

        # ---- [C] A-row packing (entries sorted by x window) ------------------
        win = cols // LANE
        order_a = np.lexsort((rows, win))
        arow, alane, n_arows = _pack_rows_128(win[order_a])
        n_sup = max(-(-n_arows // SUP_ROWS), 1)
        n_arows_pad = n_sup * SUP_ROWS
        a_vals = np.zeros((n_arows_pad, LANE), data.dtype)
        a_lidx = np.zeros((n_arows_pad, LANE), np.int32)
        a_win = np.zeros((n_arows_pad,), np.int32)
        a_rows = np.full((n_arows_pad, LANE), n_rows, np.int32)
        a_vals[arow, alane] = vals[order_a]
        a_lidx[arow, alane] = (cols[order_a] % LANE).astype(np.int32)
        first_in_row = np.concatenate([[True], arow[1:] != arow[:-1]])
        a_win[arow[first_in_row]] = win[order_a][first_in_row]
        a_rows[arow, alane] = rows[order_a].astype(np.int32)
        e_sup = arow // SUP_ROWS
        e_srcrow = arow % SUP_ROWS

        # ---- [D] arrival-layout packing --------------------------------------
        # per region, supertile contributions are packed contiguously in
        # supertile order, so each (supertile, region) run touches only
        # ceil(run/128)+1 arrival rows
        e_reg = (red_srow // REG_ROWS)[order_a]     # region per order_a position
        ord_arr = np.lexsort((np.arange(nnz), e_sup, e_reg))
        reg_sorted = e_reg[ord_arr]
        reg_new = np.empty(nnz, bool)
        reg_new[0] = True
        reg_new[1:] = reg_sorted[1:] != reg_sorted[:-1]
        reg_start = np.nonzero(reg_new)[0]
        rank = np.arange(nnz) - reg_start[np.cumsum(reg_new) - 1]
        arr_row = np.empty(nnz, np.int64)   # order_a positions
        arr_lane = np.empty(nnz, np.int64)
        arr_row[ord_arr] = reg_sorted * REG_ROWS + rank // LANE
        arr_lane[ord_arr] = rank % LANE

        # ---- [E] split assignment + touch tables -----------------------------
        split_of_entry = np.zeros(nnz, np.int64)
        blockrow_of_entry = np.zeros(nnz, np.int64)
        order_by_sup = np.argsort(e_sup, kind="stable")
        sup_starts = np.searchsorted(e_sup[order_by_sup], np.arange(n_sup + 1))
        max_splits = 1
        per_sup_splits = []
        for t in range(n_sup):
            sel = order_by_sup[sup_starts[t]:sup_starts[t + 1]]
            if sel.size == 0:
                per_sup_splits.append([np.zeros(0, np.int64)])
                continue
            sr_t = arr_row[sel]
            urows = np.unique(sr_t)
            ureg = urows // REG_ROWS
            regs, rcnt = np.unique(ureg, return_counts=True)
            # first-fit contiguous region runs into splits (≤128 rows each)
            split_first_reg = [regs[0]]
            fill = 0
            for rgi, cnt in zip(regs.tolist(), rcnt.tolist()):
                if fill + cnt > SUP_ROWS:
                    split_first_reg.append(rgi)
                    fill = 0
                fill += cnt
            bounds = np.asarray(split_first_reg, np.int64)
            n_spl_t = bounds.shape[0]
            urow_split = np.searchsorted(bounds, ureg, side="right") - 1
            splits_rows = [urows[urow_split == s_i] for s_i in range(n_spl_t)]
            per_sup_splits.append(splits_rows)
            max_splits = max(max_splits, n_spl_t)
            ent_split = np.searchsorted(bounds, sr_t // REG_ROWS, side="right") - 1
            split_of_entry[sel] = ent_split
            for s_i in range(n_spl_t):
                rows_s = splits_rows[s_i]
                in_s = ent_split == s_i
                blockrow_of_entry[sel[in_s]] = np.searchsorted(rows_s, sr_t[in_s])

        n_splits = max_splits
        touch = np.full((n_sup, n_splits, SUP_ROWS), n_srows_pad, np.int32)
        for t in range(n_sup):
            for s_i, rows_s in enumerate(per_sup_splits[t]):
                touch[t, s_i, :rows_s.shape[0]] = rows_s.astype(np.int32)

        # ---- [F] kernel-1 routing tables (edge colouring #1) ------------------
        inst_e = e_sup * n_splits + split_of_entry
        src_e = e_srcrow
        dst_e = blockrow_of_entry
        n_inst = n_sup * n_splits
        deg_src = np.zeros((n_inst, SUP_ROWS), np.int64)
        np.add.at(deg_src, (inst_e, src_e), 1)
        deg_dst = np.zeros((n_inst, SUP_ROWS), np.int64)
        np.add.at(deg_dst, (inst_e, dst_e), 1)
        inactive = ~np.isin(np.arange(n_inst), np.unique(inst_e))
        deg_src[inactive] = LANE
        deg_dst[inactive] = LANE
        def_src = (LANE - deg_src).reshape(-1)
        def_dst = (LANE - deg_dst).reshape(-1)
        ii = np.repeat(np.arange(n_inst), SUP_ROWS)
        rr = np.tile(np.arange(SUP_ROWS), n_inst)
        d_inst = np.repeat(ii, def_src)
        d_src = np.repeat(rr, def_src)
        d_dst = np.repeat(rr, def_dst)  # per-instance deficits are equal
        inst_all = np.concatenate([inst_e, d_inst])
        src_all = np.concatenate([src_e, d_src])
        dst_all = np.concatenate([dst_e, d_dst])
        colors = _euler_color_128(inst_all, src_all, dst_all)

        p1 = np.zeros((n_sup, n_splits, SUP_ROWS, LANE), np.int32)
        m1 = np.zeros((n_sup, n_splits, SUP_ROWS, LANE), np.float32)
        p2 = np.zeros((n_sup, n_splits, SUP_ROWS, LANE), np.int32)
        p3 = np.zeros((n_sup, n_splits, SUP_ROWS, LANE), np.int32)
        inst_t = inst_all // n_splits
        inst_s = inst_all % n_splits
        # P1[s, c] = source lane of the colour-c edge from A-row s (real
        # edges; dummies stay 0 and are masked by M1)
        p1[inst_t[:nnz], inst_s[:nnz], src_e, colors[:nnz]] = alane.astype(np.int32)
        m1[inst_t[:nnz], inst_s[:nnz], src_e, colors[:nnz]] = 1.0
        # P2[c, j] = s for the colour-c edge into arrival row j (with dummies)
        p2[inst_t, inst_s, colors, dst_all] = src_all.astype(np.int32)
        # P3[j, l] = colour of the edge landing at arrival lane l; unused
        # lanes point at a dummy colour into j (value 0)
        p3[inst_t[:nnz], inst_s[:nnz], dst_e, arr_lane % LANE] = \
            colors[:nnz].astype(np.int32)
        dummy_sel = np.zeros(inst_all.shape[0], bool)
        dummy_sel[nnz:] = True
        first_dummy = np.full((n_inst, SUP_ROWS), 1 << 30, np.int64)
        np.minimum.at(first_dummy, (inst_all[dummy_sel], dst_all[dummy_sel]),
                      colors[dummy_sel])
        first_dummy[first_dummy >= (1 << 30)] = 0
        used = np.zeros((n_inst, SUP_ROWS, LANE), bool)
        used[inst_e, dst_e, arr_lane % LANE] = True
        used[inactive] = True      # leave skipped instances' tables zero
        it, jt, lt = np.nonzero(~used)
        p3[it // n_splits, it % n_splits, jt, lt] = first_dummy[it, jt].astype(np.int32)

        # ---- [G] kernel-2 arrival→reduce permutation (edge colouring #2) ------
        # per region: a bijection between arrival and reduce slots.  Dummies
        # pair the empty arrival slots with the padding reduce slots; empty
        # arrival lanes sit at the END of the last partial row, so lane 127
        # of a deficient row is always empty and dummies read zeros.
        reg_e = red_srow // REG_ROWS                 # CSR order
        q_src = arr_row % REG_ROWS
        q_dst = red_srow % REG_ROWS
        inv_a = np.empty(nnz, np.int64)
        inv_a[order_a] = np.arange(nnz)
        q_src_csr = q_src[inv_a]
        arr_lane_csr = arr_lane[inv_a]
        degq_src = np.zeros((n_reg, REG_ROWS), np.int64)
        np.add.at(degq_src, (reg_e, q_src_csr), 1)
        degq_dst = np.zeros((n_reg, REG_ROWS), np.int64)
        np.add.at(degq_dst, (reg_e, q_dst), 1)
        dq_src = (LANE - degq_src).reshape(-1)
        dq_dst = (LANE - degq_dst).reshape(-1)
        qi = np.repeat(np.arange(n_reg), REG_ROWS)
        qr = np.tile(np.arange(REG_ROWS), n_reg)
        q_inst_all = np.concatenate([reg_e, np.repeat(qi, dq_src)])
        q_src_all = np.concatenate([q_src_csr, np.repeat(qr, dq_src)])
        q_dst_all = np.concatenate([q_dst, np.repeat(qr, dq_dst)])
        q_colors = _euler_color_128(q_inst_all, q_src_all, q_dst_all)

        q1 = np.full((n_reg, REG_ROWS, LANE), LANE - 1, np.int32)
        q2 = np.zeros((n_reg, REG_ROWS, LANE), np.int32)
        q3 = np.zeros((n_reg, REG_ROWS, LANE), np.int32)
        # Q1[s, c] = arrival lane of the colour-c edge from arrival row s;
        # dummies default to lane 127
        q1[reg_e, q_src_csr, q_colors[:nnz]] = arr_lane_csr.astype(np.int32)
        # Q2[c, j] = s for the colour-c edge into reduce row j (with dummies)
        q2[q_inst_all, q_colors, q_dst_all] = q_src_all.astype(np.int32)
        # Q3[j, l] = colour of the edge landing at reduce lane l; unused
        # lanes take a dummy colour into j (zero value)
        q3[reg_e, q_dst, red_slane % LANE] = q_colors[:nnz].astype(np.int32)
        q_dummy = np.zeros(q_inst_all.shape[0], bool)
        q_dummy[nnz:] = True
        firstq = np.full((n_reg, REG_ROWS), 1 << 30, np.int64)
        np.minimum.at(firstq, (q_inst_all[q_dummy], q_dst_all[q_dummy]),
                      q_colors[q_dummy])
        firstq[firstq >= (1 << 30)] = 0
        usedq = np.zeros((n_reg, REG_ROWS, LANE), bool)
        usedq[reg_e, q_dst, red_slane % LANE] = True
        it2, jt2, lt2 = np.nonzero(~usedq)
        q3[it2, jt2, lt2] = firstq[it2, jt2].astype(np.int32)

        return done(a_vals=a_vals, a_lidx=a_lidx, a_win=a_win, a_rows=a_rows,
                    p1=p1, m1=m1.astype(data.dtype), p2=p2, p3=p3, touch=touch,
                    q1=q1, q2=q2, q3=q3, lpos=lpos, ppos=ppos,
                    pmask=pmask.astype(data.dtype),
                    segmask=segmask.astype(data.dtype), wrow=wrow)

    # -- canonical views --------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows = self.shape[0]
        rows = self.a_rows.reshape(-1)
        cols = (self.a_win[:, None] * LANE + self.a_lidx).reshape(-1)
        vals = self.a_vals.reshape(-1)
        ok = rows < n_rows
        return COO(rows=torch.where(ok, rows, n_rows).to(torch.int32),
                   cols=torch.where(ok, cols, 0),
                   vals=torch.where(ok, vals, 0),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    def to_route(self) -> "RouteStream":
        return self

    # -- structure ----------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.a_vals.numel())

    @property
    def n_sup(self) -> int:
        return int(self.p1.shape[0])

    @property
    def n_splits(self) -> int:
        return int(self.p1.shape[1])

    @property
    def n_regions(self) -> int:
        return int(self.lpos.shape[0])

    @property
    def index_dtype(self):
        return torch.int32

    @property
    def data(self):
        return self.a_vals

    def n_non_zero_entries(self) -> int:
        return int((self.host("a_rows") < self.shape[0]).sum())

    def scale(self, scalar) -> "RouteStream":
        return dataclasses.replace(self, a_vals=self.a_vals * scalar)

    def fill_ratio(self) -> float:
        return self.n_non_zero_entries() / max(self.nse, 1)

    def x_windows(self) -> int:
        return max(-(-self.shape[1] // LANE), 1)

    def y_windows(self) -> int:
        return max(-(-self.shape[0] // LANE), 1)

    def vmem_resident_bytes(self, itemsize: int = 4) -> int:
        """The JAX package's TPU kernel-1 VMEM bound (resident staging and
        x, the triple-buffered per-step tables, scratch).  Kept for parity;
        nothing in the port's dispatch reads it."""
        staging = (self.n_regions * REG_ROWS + SUP_ROWS) * LANE * itemsize
        x = self.x_windows() * LANE * itemsize
        y = (self.y_windows() + 1) * LANE * itemsize
        per_step = (4 * self.n_splits + 2) * SUP_ROWS * LANE * itemsize
        scratch = (2 * SUP_ROWS + 8) * LANE * itemsize
        return staging + max(x, y) + 3 * per_step + scratch

    def smem_prefetch_bytes(self) -> int:
        """The JAX package's TPU scalar-prefetch bytes (``touch`` and
        ``a_win``).  Kept for parity; nothing in the port reads it."""
        return (self.n_sup * self.n_splits * SUP_ROWS * 4 + self.n_sup * SUP_ROWS * 4)

    def spmv_traffic_bytes(self) -> int:
        """Layout bytes per SpMV: every array the kernels read once (all but
        ``a_rows``), the staging round trip (counted at 4 bytes a slot, as
        the JAX package counts it), x read once and y written once: what
        the TPU kernels stream (the port's kernel reads the G = 1 plan)."""
        staging = (self.n_regions * REG_ROWS + SUP_ROWS) * LANE * 4
        return super().spmv_traffic_bytes() + 2 * staging
