"""The row-group plan shared by the SpMV and SpMM of BSR, WELL, SlabELL,
SlabPack, StripELL, SlabStream and RouteStream (a BSR's SpMV aside, which
goes through COO): a compact launch plan built once per matrix
(``plan_of``), the bindings of
the two CUDA kernels that walk it (``csrc/spmm.cu`` and ``csrc/spmv.cu``,
see the notes there for what they replace and what bounds them), and plain
walks of the plan in each kernel's order.

The plan holds exactly the entries the format's own ``to_coo`` counts
(stored zeros stay, zero blocks and padding slots go), whose row and
column lie inside the matrix: a StripELL's strips and a SlabStream's
chunks come down to the same plan as any other freeze of the same CSR.
Rows are cut into groups of G consecutive rows (G ≤ 8, the same for the
whole matrix); each group keeps one sorted list of the union of its rows'
columns, and each row one value per union column (zero where it has no
entry) beside a bit that says whether it has one.  G is chosen per matrix,
unless the caller names it, to minimise the bytes one column tile of the
product reads: the plan's columns, masks and values,
and one 512-byte B slice per union column.  On a dof-blocked FEM operator
the dof rows of a node share their columns and G comes out at the dof
count; on a scattered matrix groups of 1 win, which are plain compact
rows.  A row with two entries at one column (which no freeze makes) gets
a union column for each, so every entry is its own term.

The SpMV splits the plan's union columns over sub-warps of L lanes
(``SpmvSplit``, built once per plan): L from the mean union columns per
group, and a group longer than a segment (2·UNROLL·L union columns) cut
into segments whose partial sums the last one to finish adds in order.
The SpMM gives each row group a warp per column tile of B (128 f32 or 64
f64 columns), or, where B is narrower than a tile, a sub-warp of
``spmm_lanes`` lanes, so a warp walks 32 / L groups at once
(``LANE_LAUNCHES`` counts launches by that width).

A RouteStream's plan is built at G = 1, where it is the matrix's CSR
(``grp_ptr`` the row pointers, ``cols`` and ``vals`` the entries in row
order), and its SpMV (``csrc/route.cu``, bound in ``kernels/route.py``)
takes the nnz-balanced split of ``MergeSplit`` instead, whose tiles do not
depend on how the row lengths spread; its SpMM walks the same plan with the
row-group SpMM, at groups of one row.

The plan lives beside the format (the frozen layouts stay bit-equal to
the JAX freezes); its code is plain torch on any device, so the CPU tests
build and walk it.  Which formats run their products over a plan, and
under which counter key, is ``ops/matvec.py``'s table ``PLANNED``; every
launch over a plan is counted here, in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .._build import load_cuda
from ..formats.bsr import BSR
from ..formats.route import RouteStream
from ..types import FLOAT_DTYPES, accum_dtype
from ..utils import profiling

#: kernel launches over a plan, by the product's key (the plain versions do
#: not count): one per product, any number of parts or overflow levels
LAUNCHES = profiling.register("kernels.plan", {
    "strip_spmv": 0, "strip_spmm": 0, "well_spmv": 0, "well_spmm": 0, "slab_spmv": 0,
    "slab_spmm": 0, "slab_stream_spmv": 0, "slab_stream_spmm": 0, "route_spmv": 0,
    "route_spmm": 0, "bsr_spmm": 0})

#: the SpMM's lanes a row group: a sub-warp below a full column tile, a
#: whole warp (32) at and past one
SPMM_LANES = (1, 2, 4, 8, 16, 32)
#: SpMM launches by the lanes each row group took (``spmm_lanes``); the
#: plain versions do not count
LANE_LAUNCHES = profiling.register("kernels.spmm_lanes", {str(L): 0 for L in SPMM_LANES})

#: the largest row group (the kernels' mask is 8 bits)
MAX_GROUP = 8
#: bytes of B a warp gathers per union column at a full column tile
_TILE_BYTES = 512
#: block slots whose stored-entry mask one step of a BSR's entry scan holds
_ENTRY_CHUNK = 1 << 28
#: union columns one SpMV lane loads per pass (its gathers of x in flight)
UNROLL = 4
#: the SpMV's sub-warp widths
LANES = (4, 8, 16, 32)
#: threads of one tile of the merge-path SpMV (``csrc/route.cu`` THREADS)
MERGE_THREADS = 256
#: the most merge items one tile holds (``csrc/route.cu`` MAX_ITEMS), 8 a thread
MERGE_MAX_ITEMS = 2048
#: merge items a tile holds unless its split names another count
MERGE_ITEMS = 1536
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_libs = {}
_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def reset_launches() -> None:
    for counts in (LAUNCHES, LANE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def spmm_lanes(m: int, itemsize: int) -> int:
    """Lanes of one row group in the row-group SpMM of B with ``m`` columns
    of ``itemsize`` bytes: the fewest of ``SPMM_LANES`` whose 16-byte
    slices, 16 // itemsize columns a lane, cover m, and 32 (a warp a group,
    walking column tiles) past one tile.  The 16-byte and the scalar path
    take the same count."""
    width = 16 // itemsize
    return next(L for L in SPMM_LANES if L * width >= m or L == SPMM_LANES[-1])


def _bind(name: str, fn_prefix: str, argtypes) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` library with its two launchers bound."""
    lib = _libs.get(name)
    if lib is None:
        lib = load_cuda(name)
        for s in _SUFFIX.values():
            fn = getattr(lib, f"{fn_prefix}_{s}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, f"smt_{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/spmm.cu`` library."""
    return _bind("spmm", "smt_rowgroup_spmm",
                 [_VP, _VP, _VP, _VP, _I64, _I64, _I32, _I64, _I64, _VP, _VP, _I32, _I32, _VP])


def _spmv_kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/spmv.cu`` library."""
    return _bind("spmv", "smt_rowgroup_spmv",
                 [_VP, _VP, _VP, _I64, _VP, _VP, _VP, _I64, _I32, _I32, _I64, _VP, _VP, _VP,
                  _VP, _VP])


class Plan:
    """The compact form of one matrix: ``grp_ptr`` (n_groups + 1,) int64
    union-column range of each group; ``cols`` (U,) int32; ``mask`` (U,)
    uint8, bit i for row g·G + i; ``vals`` (G, U) in the accumulation dtype
    of the matrix's values."""

    def __init__(self, grp_ptr, cols, mask, vals, group: int, shape, nnz: int):
        self.grp_ptr, self.cols, self.mask, self.vals = grp_ptr, cols, mask, vals
        self.group = group
        self.shape = tuple(shape)
        self.nnz = nnz
        self._cast = {vals.dtype: vals}
        self._spmv = None
        self._merge = None

    @property
    def n_groups(self) -> int:
        return self.grp_ptr.numel() - 1

    @property
    def n_union(self) -> int:
        return self.cols.numel()

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.grp_ptr, self.cols, self.mask, self.vals))

    @property
    def padding(self) -> float:
        """Share of the plan's value slots that hold no entry."""
        return 1.0 - self.nnz / max(self.n_union * self.group, 1)

    @property
    def spmv(self) -> "SpmvSplit":
        """The SpMV's work split, built at first use and kept."""
        if self._spmv is None:
            self._spmv = SpmvSplit(self)
        return self._spmv

    @property
    def merge(self) -> "MergeSplit":
        """The merge-path SpMV's split of a G = 1 plan, built at first use
        and kept."""
        if self._merge is None:
            self._merge = MergeSplit(self)
        return self._merge

    def vals_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The values in ``dtype``, cast once and kept."""
        if dtype not in self._cast:
            self._cast[dtype] = self.vals.to(dtype)
        return self._cast[dtype]


class SpmvSplit:
    """The row-group SpMV's work over a plan: ``lanes`` (L) per sub-warp,
    the smallest of ``LANES`` whose one pass (L·UNROLL union columns)
    covers a group of the mean length; segments of at most ``seg_cols``
    union columns, each a run of one group's columns, a group cut into as
    many as it needs and an empty group one empty segment.  ``seg_ptr``
    (n_seg + 1,) int64 union-column bounds; ``seg_tag`` (n_seg,) int32 the
    group of a group's only segment, or -1 - k for a segment of the k-th
    group of several; ``multi`` (n_multi, 4) int32 rows (group, first
    segment, segment count, first partial slot)."""

    def __init__(self, plan: Plan, lanes: int | None = None, seg_cols: int | None = None):
        dev = plan.grp_ptr.device
        if lanes is None:
            mean = plan.n_union / max(plan.n_groups, 1)
            lanes = next((L for L in LANES if L * UNROLL >= mean), LANES[-1])
        if lanes not in LANES:
            raise ValueError(f"row-group SpMV: {lanes} lanes, not one of {LANES}")
        self.lanes, self.group = lanes, plan.group
        self.seg_cols = seg_cols or 2 * UNROLL * lanes
        start = plan.grp_ptr[:-1]
        n_seg_g = torch.clamp((plan.grp_ptr[1:] - start + self.seg_cols - 1) // self.seg_cols,
                              min=1)
        first = torch.cumsum(n_seg_g, 0) - n_seg_g
        owner = torch.repeat_interleave(torch.arange(plan.n_groups, device=dev), n_seg_g)
        self.n_seg = int(owner.numel())
        seg_start = start[owner] + (torch.arange(self.n_seg, device=dev) - first[owner]) \
            * self.seg_cols
        self.seg_ptr = torch.cat([seg_start, plan.grp_ptr[-1:]])
        multi = n_seg_g > 1
        multi_id = torch.cumsum(multi.long(), 0) - 1
        self.seg_tag = torch.where(multi[owner], -1 - multi_id[owner], owner).to(torch.int32)
        count = n_seg_g[multi]
        self.multi = torch.stack([torch.nonzero(multi).flatten(), first[multi], count,
                                  torch.cumsum(count, 0) - count], 1).to(torch.int32)
        self.n_multi = int(self.multi.shape[0])
        self.n_partial = int(count.sum())
        if max(self.n_seg, plan.n_groups, self.n_partial) >= 1 << 31:
            raise ValueError("row-group SpMV: more than 2^31 segments")
        self._scratch = {}

    def scratch(self, stream, dtype: torch.dtype):
        """(partial, tickets) of launches on ``stream`` in ``dtype``: the
        slots of the partial sums (None where no group has several
        segments) and the arrival counters of the groups of several
        segments (``_scratch``)."""
        return _scratch(self._scratch, stream, dtype, self.n_partial * self.group,
                        self.n_multi, self.seg_ptr.device)


class MergeSplit:
    """The merge-path SpMV's work over a G = 1 plan (Merrill & Garland,
    "Merge-based Parallel Sparse Matrix-Vector Multiplication", SC16).  The
    merge of the n_rows row ends with the nnz entries (a row's end after
    its last entry, n_rows + nnz items) is cut into tiles of ``items``
    items, one CTA each, and a tile into runs of ``ipt`` = ⌈items /
    MERGE_THREADS⌉ items, one thread each, so no CTA or thread holds more
    work than another, however the row lengths spread.  ``starts``
    (n_tiles + 1, 2) int64: the (row, entry) coordinate of each tile's
    first item, and of the end, where the diagonal search puts them (the
    row ends and entries before that item); ``spans`` (n_span, 4) int32:
    rows (row, first tile, tile count, first partial slot) of the rows
    whose items lie in more than one tile; ``tile_span`` (n_tiles, 2)
    int32: the span of the row a tile finds open at its start (begun in an
    earlier tile) and of the row it leaves open at its end, -1 where none.
    Static per matrix: the kernel loads its tile's bounds and searches
    nothing across tiles."""

    def __init__(self, plan: Plan, items: int | None = None):
        if plan.group != 1:
            raise ValueError(f"merge-path SpMV: the plan has groups of {plan.group} rows, "
                             f"it needs 1")
        items = items or MERGE_ITEMS
        if not 1 <= items <= MERGE_MAX_ITEMS:
            raise ValueError(f"merge-path SpMV: {items} items a tile, the kernel takes "
                             f"1 to {MERGE_MAX_ITEMS}")
        dev = plan.grp_ptr.device
        n_rows, nnz = plan.n_groups, plan.n_union
        total = n_rows + nnz
        self.items, self.ipt = items, -(-items // MERGE_THREADS)
        self.n_tiles = -(-total // items)
        rows = torch.arange(n_rows, device=dev)
        end = plan.grp_ptr[1:] + rows            # merge position of each row's end
        first = plan.grp_ptr[:-1] + rows         # of its first item (its end if empty)
        diag = torch.clamp(torch.arange(self.n_tiles + 1, device=dev) * items, max=total)
        row = torch.searchsorted(end, diag)      # the diagonal search: row ends before d
        self.starts = torch.stack([row, diag - row], 1)
        t_first, t_last = first // items, end // items
        multi = t_last > t_first
        span_id = torch.cumsum(multi.long(), 0) - 1
        count = (t_last - t_first + 1)[multi]
        self.spans = torch.stack([torch.nonzero(multi).flatten(), t_first[multi], count,
                                  torch.cumsum(count, 0) - count], 1).to(torch.int32)
        self.n_span = int(self.spans.shape[0])
        self.n_partial = int(count.sum())
        self.longest = int(count.max()) if self.n_span else 0
        tile = torch.arange(self.n_tiles, device=dev)
        r0 = row[:-1].clamp(max=max(n_rows - 1, 0))     # the row open at a tile's start
        r1 = row[1:].clamp(max=max(n_rows - 1, 0))      # and at its end
        open0 = (row[:-1] < n_rows) & (t_first[r0] < tile)
        open1 = (row[1:] < n_rows) & (first[r1] < diag[1:])
        self.tile_span = torch.stack([torch.where(open0, span_id[r0], -1),
                                      torch.where(open1, span_id[r1], -1)], 1).to(torch.int32)
        if max(n_rows, self.n_tiles, self.n_partial) >= 1 << 31:
            raise ValueError("merge-path SpMV: more than 2^31 rows, tiles or partials")
        self._scratch = {}

    def scratch(self, stream, dtype: torch.dtype):
        """(partial, tickets) of launches on ``stream`` in ``dtype``: one
        partial slot per (spanning row, tile), and one arrival counter per
        spanning row (``_scratch``)."""
        return _scratch(self._scratch, stream, dtype, self.n_partial, self.n_span,
                        self.starts.device)


def _scratch(store: dict, stream, dtype: torch.dtype, n_partial: int, n_tickets: int, dev):
    """(partial, tickets) of a split's launches on ``stream`` in ``dtype``:
    ``n_partial`` slots for the partial sums (None where there are none),
    and ``n_tickets`` int32 arrival counters at 0, which the kernel's last
    arrival leaves at 0.

    An eager launch takes the pair of its stream, made and zeroed once and
    kept in ``store`` (the launches of one stream run in order).  A launch
    being captured into a CUDA graph takes a pair of its own from the
    graph's memory pool, its counters zeroed by a fill that the graph
    replays before the kernel, as ``kernels/dia.py`` ``dot_scratch`` does:
    so no eager launch on the capture's stream keeps memory of the graph's
    pool, and no replay reads counters that another launch left in use."""
    def made():
        partial = torch.empty(n_partial, dtype=dtype, device=dev) if n_partial else None
        return partial, torch.zeros(max(n_tickets, 1), dtype=torch.int32, device=dev)

    if torch.cuda.is_current_stream_capturing():
        return made()
    key = (stream.cuda_stream, dtype)
    if key not in store:
        store[key] = made()
    return store[key]


def build(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, shape,
          group: int | None = None) -> Plan:
    """The plan of the entries (rows, cols, vals), in any order, on their
    device, at groups of ``group`` rows (None: the G that minimises the
    SpMM's tile bytes); entries outside the matrix are dropped (a padding
    slot of ``to_coo`` is one) before the indices are widened to int64, so
    a padded layout's slots never take 16 bytes each."""
    if group is not None and not 1 <= group <= MAX_GROUP:
        raise ValueError(f"row-group plan: groups of {group} rows, not 1 to {MAX_GROUP}")
    n_rows, n_cols = (int(s) for s in shape)
    dev = vals.device
    vdt = accum_dtype(vals.dtype)
    keep = (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < n_cols)
    rows, cols, vals = rows[keep].long(), cols[keep].long(), vals[keep].to(vdt)
    nnz = int(rows.numel())
    # (row, col) order, entries at one (row, col) kept in input order and
    # told apart by their rank among them
    key, order = torch.sort(rows * n_cols + cols, stable=True)
    rows, cols, vals = rows[order], cols[order], vals[order]
    dup = torch.zeros(nnz, dtype=torch.int64, device=dev)
    if nnz:
        idx = torch.arange(nnz, device=dev)
        first = torch.ones(nnz, dtype=torch.bool, device=dev)
        first[1:] = key[1:] != key[:-1]
        dup = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    n_dup = int(dup.max()) + 1 if nnz else 1
    if n_rows * max(n_cols, 1) * n_dup >= 1 << 62:
        raise ValueError(f"row-group plan: a {shape} matrix with {n_dup} entries at one "
                         f"position overflows the int64 slot key")

    def slot_key(g: int) -> torch.Tensor:
        return ((rows // g) * n_cols + cols) * n_dup + dup

    def tile_bytes(g: int):
        """Bytes one column tile reads at groups of g: per union column its
        column, mask and g values, and a B slice (ties go to the smaller g)."""
        return torch.unique(slot_key(g)).numel() * (4 + 1 + g * vdt.itemsize + _TILE_BYTES), g

    if group is None:
        group = min(range(1, min(MAX_GROUP, max(n_rows, 1)) + 1), key=tile_bytes)

    uniq, slot = torch.unique(slot_key(group), sorted=True, return_inverse=True)
    n_groups = -(-n_rows // group)
    counts = torch.bincount(uniq // (n_dup * n_cols), minlength=n_groups) if nnz else \
        torch.zeros(n_groups, dtype=torch.int64, device=dev)
    grp_ptr = torch.zeros(n_groups + 1, dtype=torch.int64, device=dev)
    grp_ptr[1:] = torch.cumsum(counts, 0)
    within = rows % group
    pvals = torch.zeros((group, uniq.numel()), dtype=vdt, device=dev)
    pvals[within, slot] = vals                                # one entry per (row, slot)
    mask = torch.zeros(uniq.numel(), dtype=torch.int64, device=dev)
    mask.index_add_(0, slot, 1 << within)                     # distinct bits: a sum is an or
    return Plan(grp_ptr, ((uniq // n_dup) % max(n_cols, 1)).to(torch.int32),
                mask.to(torch.uint8), pvals, group, (n_rows, n_cols), nnz)


def bsr_entries(bsr: BSR):
    """(rows, cols, vals) of a BSR's stored entries, as ``to_coo`` counts
    them, read from the blocks on their device a few hundred MB of mask at
    a time (the 3.6 GB of a large low-fill freeze never leave the card)."""
    t, br, bc = bsr.blocks.shape
    step = max(_ENTRY_CHUNK // max(br * bc, 1), 1)
    parts = []
    for t0 in range(0, t, step):
        blocks = bsr.blocks[t0:t0 + step]
        stored = bsr.occ[t0:t0 + step] if bsr.occ is not None else blocks != 0
        ti, r, k = torch.nonzero(stored, as_tuple=True)
        parts.append((bsr.block_rows[t0 + ti].long() * br + r,
                      bsr.block_cols[t0 + ti].long() * bc + k, blocks[ti, r, k]))
    if not parts:
        empty = torch.zeros(0, dtype=torch.int64, device=bsr.blocks.device)
        return empty, empty, bsr.blocks.new_zeros(0)
    return tuple(torch.cat(x) for x in zip(*parts))


def _tensors(obj):
    """Every tensor reachable through a format's dataclass fields, its
    parts' and overflow levels' included."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)


def _check_layout(mat) -> None:
    """Every array of the matrix on its values' device, and float values:
    checked once per matrix, when its plan is built.  A launch also needs
    its operand on that device (``_common.check_operand``), and takes the
    plain version where both lie on the CPU, so every launch finds the
    matrix on one CUDA device."""
    dev = mat.device
    if any(t.device != dev for t in _tensors(mat)):
        raise ValueError(f"{type(mat).__name__} kernels: the kernels need every array on "
                         f"one CUDA device, the values are on {dev}")
    if mat.dtype not in FLOAT_DTYPES:
        raise TypeError(f"{type(mat).__name__} kernels: the CUDA kernels take float values, "
                        f"got {mat.dtype}")


def plan_of(mat) -> Plan:
    """The plan of a BSR, WELL, SlabELL, SlabPack (every part and every
    overflow level in one), StripELL (every class part), SlabStream or
    RouteStream (at G = 1: its CSR), shared by its SpMV and its SpMM (on a
    card, every product of these formats but a BSR's SpMV): built on
    the matrix's device at first use (a BSR's entries from its blocks, the
    others' from ``to_coo``), after ``_check_layout``, and cached on it (a
    frozen matrix's layout and values never change).  A build is the
    set-up span ``freeze.plan``."""
    plan = mat.__dict__.get("_rowgroup_plan")
    if plan is None:
        with profiling.span("freeze.plan", setup=True):
            _check_layout(mat)
            if isinstance(mat, BSR):
                entries = bsr_entries(mat)
            else:
                coo = mat.to_coo()
                entries = (coo.rows, coo.cols, coo.vals)
            plan = build(*entries, mat.shape,
                         group=1 if isinstance(mat, RouteStream) else None)
            object.__setattr__(mat, "_rowgroup_plan", plan)
    return plan


def walk(plan: Plan, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B by the SpMM kernel's arithmetic in its order, in plain
    torch: each row's terms summed over its group's union columns in
    order, a masked-off term skipped.  For the tests (the products' plain
    versions are the formats' own)."""
    adt = accum_dtype(torch.promote_types(plan.vals.dtype, B.dtype))
    G, m = plan.group, B.shape[1]
    vals, Bc = plan.vals.to(adt), B.to(adt)
    acc = torch.zeros((plan.n_groups, G, m), dtype=adt, device=B.device)
    start = plan.grp_ptr[:-1]
    lens = plan.grp_ptr[1:] - start
    for k in range(int(lens.max()) if plan.n_groups else 0):
        g = torch.nonzero(lens > k).flatten()
        u = start[g] + k
        b = Bc[plan.cols[u].long()]
        bits = plan.mask[u].long()
        for i in range(G):
            on = ((bits >> i) & 1).bool()[:, None]
            acc[g, i] = torch.where(on, acc[g, i] + vals[i, u][:, None] * b, acc[g, i])
    return acc.reshape(plan.n_groups * G, m)[: plan.shape[0]]


def spmv_walk(plan: Plan, x: torch.Tensor, split: SpmvSplit | None = None) -> torch.Tensor:
    """y = A @ x by the SpMV kernel's arithmetic in its order, in plain
    torch: each lane's sums over its union columns (lane, lane + L, ... of
    its segment), a masked-off term skipped; the L lane sums added by the
    kernel's butterfly; a group's segment sums added in segment order.
    ``split`` defaults to the plan's own.  For the tests."""
    split = split or plan.spmv
    adt = accum_dtype(torch.promote_types(plan.vals.dtype, x.dtype))
    G, L = plan.group, split.lanes
    vals, xc = plan.vals.to(adt), x.to(adt)
    dev = x.device
    start = split.seg_ptr[:-1, None]
    lens = split.seg_ptr[1:, None] - start
    lane = torch.arange(L, device=dev)
    acc = torch.zeros((split.n_seg, L, G), dtype=adt, device=dev)
    for k in range(0, int(lens.max()) if split.n_seg else 0, L):
        inside = k + lane < lens                                  # (n_seg, L)
        u = torch.where(inside, start + k + lane, 0)
        b = xc[plan.cols[u].long()]
        bits = torch.where(inside, plan.mask[u].long(), 0)
        for i in range(G):
            on = ((bits >> i) & 1).bool()
            acc[..., i] = torch.where(on, acc[..., i] + vals[i, u] * b, acc[..., i])
    off = 1
    while off < L:                                                # __shfl_xor_sync
        acc = acc + acc[:, lane ^ off]
        off <<= 1
    seg = acc[:, 0]                                               # (n_seg, G)
    y = torch.zeros((plan.n_groups, G), dtype=adt, device=dev)
    single = split.seg_tag >= 0
    y[split.seg_tag[single].long()] = seg[single]
    grp, first, count = (split.multi[:, j].long() for j in range(3))
    sums = torch.zeros((split.n_multi, G), dtype=adt, device=dev)
    for j in range(int(count.max()) if split.n_multi else 0):
        on = count > j
        sums[on] = sums[on] + seg[first[on] + j]
    y[grp] = sums
    return y.reshape(-1)[: plan.shape[0]]


def launch(plan: Plan, B: torch.Tensor, launches: dict, name: str) -> torch.Tensor:
    """Y = A @ B through ``rowgroup_spmm_kernel``, one launch (counted in
    ``launches[name]``, and in ``LANE_LAUNCHES`` by its ``spmm_lanes``); B
    (n_cols, m) on the plan's CUDA device.  bf16/f16 values and B are
    computed in f32."""
    n_rows, _ = plan.shape
    m = B.shape[1]
    adt = accum_dtype(torch.promote_types(plan.vals.dtype, B.dtype))
    vals = plan.vals_as(adt)
    Bc = B.to(adt).contiguous()
    Y = torch.empty((n_rows, m), dtype=adt, device=B.device)
    if Y.numel() == 0:
        return Y
    vec = int(m % (16 // adt.itemsize) == 0 and Bc.data_ptr() % 16 == 0
              and Y.data_ptr() % 16 == 0)
    lanes = spmm_lanes(m, adt.itemsize)
    lib = _kernels()
    with torch.cuda.device(B.device):
        rc = getattr(lib, f"smt_rowgroup_spmm_{_SUFFIX[adt]}")(
            plan.grp_ptr.data_ptr(), plan.cols.data_ptr(), plan.mask.data_ptr(),
            vals.data_ptr(), plan.n_union, plan.n_groups, plan.group, n_rows, m,
            Bc.data_ptr(), Y.data_ptr(), vec, lanes,
            torch.cuda.current_stream(B.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({lib.smt_spmm_error_string(rc).decode()})")
    launches[name] += 1
    LANE_LAUNCHES[str(lanes)] += 1
    return Y


def launch_spmv(plan: Plan, x: torch.Tensor, launches: dict, name: str) -> torch.Tensor:
    """y = A @ x through ``rowgroup_spmv_kernel``, one launch (counted in
    ``launches[name]``); x (n_cols,) on the plan's CUDA device.  bf16/f16
    values and x are computed in f32."""
    n_rows, _ = plan.shape
    adt = accum_dtype(torch.promote_types(plan.vals.dtype, x.dtype))
    vals = plan.vals_as(adt)
    xc = x.to(adt).contiguous()
    y = torch.empty(n_rows, dtype=adt, device=x.device)
    if n_rows == 0:
        return y
    split = plan.spmv
    stream = torch.cuda.current_stream(x.device)
    partial, tickets = split.scratch(stream, adt)
    lib = _spmv_kernels()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"smt_rowgroup_spmv_{_SUFFIX[adt]}")(
            plan.cols.data_ptr(), plan.mask.data_ptr(), vals.data_ptr(), plan.n_union,
            split.seg_ptr.data_ptr(), split.seg_tag.data_ptr(), split.multi.data_ptr(),
            split.n_seg, plan.group, split.lanes, n_rows, xc.data_ptr(), y.data_ptr(),
            partial.data_ptr() if partial is not None else None, tickets.data_ptr(),
            stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({lib.smt_spmv_error_string(rc).decode()})")
    launches[name] += 1
    return y
