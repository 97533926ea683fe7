"""RouteStream SpMV: the merge-path CUDA kernel's binding, the plain
versions and the kernel's walk (counterpart of
``sparsemat_tpu/kernels/route.py``).

The TPU's SpMV is two kernels over the freeze's routing tables (gather into
a staging buffer, then reduce).  The port's is one launch of the merge-path
CSR SpMV (``csrc/route.cu``, see the note there for what it replaces and
what bounds it) over the matrix's compact plan at G = 1
(``kernels/_rowgroup.py`` ``plan_of``: the CSR of ``to_coo``, padding
dropped, built on the matrix's device at first use and cached on it), cut
into nnz-balanced tiles by ``_rowgroup.MergeSplit`` (built once per plan).
The routing tables stay in the format, bit-equal to the JAX freeze, and the
kernel reads none of them.  ``ops/matvec.py`` launches it on CUDA tensors
and takes ``route_spmv_ref`` on CPU tensors; the SpMM is the row-group
SpMM over the same G = 1 plan, and its plain version the JAX package's
path through CSR.

The plain versions replay the JAX package's table semantics
(``route_spmv_xla``) in two halves, ``route_gather_ref`` and
``route_reduce_ref``, with tensor ops vectorised over supertiles and
regions where the JAX package scans, so the kernel and its plain version
are independent.  ``route_spmv_walk`` is the kernel's arithmetic in its
order, in plain torch, for the tests.

Dtypes: the values and x are computed in the accumulation dtype of the two
(bf16/f16 in f32); the kernel runs in f32 or f64.  One difference from the
plain versions: the kernel reads no padding slot, so where x holds inf or
NaN it gives what a CSR product gives (scipy, ``torch.mv``), not a slot's
0·inf = NaN; for a finite operand they agree.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.route import LANE, REG_ROWS, SUP_ROWS, RouteStream
from ..types import accum_dtype
from .._build import load_cuda
from . import _rowgroup

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/route.cu`` library."""
    global _lib
    if _lib is None:
        lib = load_cuda("route")
        vp = ctypes.c_void_p
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_route_spmv_{s}")
            fn.argtypes = [vp] * 6 + [ctypes.c_int64, ctypes.c_int] + [vp] * 5
            fn.restype = ctypes.c_int
        lib.smt_route_error_string.argtypes = [ctypes.c_int]
        lib.smt_route_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def staging_rows(rs: RouteStream) -> int:
    """Rows of the plain versions' staging buffer: the regions' rows plus
    one spare region that unused ``touch`` entries name."""
    return rs.n_regions * REG_ROWS + SUP_ROWS


def _adt(rs: RouteStream, x: torch.Tensor) -> torch.dtype:
    return accum_dtype(torch.promote_types(rs.dtype, x.dtype))


# --- plain versions ------------------------------------------------------------

def route_gather_ref(rs: RouteStream, x: torch.Tensor) -> torch.Tensor:
    """(staging_rows, 128) staging buffer: every product a_vals·x routed by
    the 3-phase tables of each (supertile, split) and added into the rows
    ``touch`` names — the first half of the JAX package's
    ``route_spmv_xla``.  A column ≥ n_cols reads 0 (zero-padded x windows)."""
    adt = _adt(rs, x)
    n_sup, n_spl = rs.n_sup, rs.n_splits
    xw = F.pad(x.to(adt), (0, rs.x_windows() * LANE - x.shape[0])).reshape(-1, LANE)
    g = torch.gather(xw[rs.a_win.long()], 1, rs.a_lidx.long())
    prod = (rs.a_vals.to(adt) * g).reshape(n_sup, SUP_ROWS, LANE)
    staging = torch.zeros(staging_rows(rs), LANE, dtype=adt, device=x.device)
    for s in range(n_spl):
        b1 = torch.gather(prod, 2, rs.p1[:, s].long()) * rs.m1[:, s].to(adt)
        b3 = torch.gather(b1.transpose(1, 2), 2, rs.p2[:, s].long())
        b5 = torch.gather(b3.transpose(1, 2), 2, rs.p3[:, s].long())
        staging.index_add_(0, rs.touch[:, s].reshape(-1).long(), b5.reshape(-1, LANE))
    return staging


def route_reduce_ref(rs: RouteStream, staging: torch.Tensor) -> torch.Tensor:
    """y (n_rows,): each region permuted from arrival to reduce layout
    (``q1``/``q2``/``q3``), a lane prefix sum as a product with the
    upper-triangular ones matrix, segment sums ``(P[lpos] − P[ppos]·pmask)·
    segmask`` added into the y windows ``wrow`` — the second half of
    ``route_spmv_xla``.  On a card the product runs in full f32 (TF32 is
    off by default)."""
    adt = staging.dtype
    n_reg = rs.n_regions
    n_ywin = rs.y_windows()
    stag3 = staging[: n_reg * REG_ROWS].reshape(n_reg, REG_ROWS, LANE)
    b1 = torch.gather(stag3, 2, rs.q1.long())
    b3 = torch.gather(b1.transpose(1, 2), 2, rs.q2.long())
    blk = torch.gather(b3.transpose(1, 2), 2, rs.q3.long())
    tri = torch.triu(torch.ones(LANE, LANE, dtype=adt, device=staging.device))
    prefix = torch.matmul(blk, tri)
    e1 = torch.gather(prefix, 2, rs.lpos.long())
    e0 = torch.gather(prefix, 2, rs.ppos.long())
    seg = (e1 - e0 * rs.pmask.to(adt)) * rs.segmask.to(adt)
    y = torch.zeros(n_ywin + 1, LANE, dtype=adt, device=staging.device)
    y.index_add_(0, rs.wrow.reshape(-1).long(), seg.reshape(-1, LANE))
    return y[:n_ywin].reshape(-1)[: rs.shape[0]]


def route_spmv_ref(rs: RouteStream, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through both plain halves."""
    return route_reduce_ref(rs, route_gather_ref(rs, x))


# --- the layout's invariants (the freeze gives them) ---------------------------

def slot_owners(rs: RouteStream) -> np.ndarray:
    """The staging slot (row·128 + lane) that each real product of the
    gather lands on, from the host tables; the freeze gives every real
    product a slot of its own: for arrival slot (j, l) of each
    (supertile, split), colour c = p3[j, l], source row s = p2[c, j], and the
    slot is real where m1[s, c] ≠ 0."""
    p1, m1, p2, p3 = (rs.host(k) for k in ("p1", "m1", "p2", "p3"))
    touch = rs.host("touch").astype(np.int64)
    n_sup, n_spl = p1.shape[:2]
    t = np.arange(n_sup)[:, None, None, None]
    s_ = np.arange(n_spl)[None, :, None, None]
    j = np.arange(SUP_ROWS)[None, None, :, None]
    l = np.arange(LANE)[None, None, None, :]
    c = p3
    src = p2[t, s_, c, j]
    real = m1[t, s_, src, c] != 0
    dest = touch[t, s_, j] * LANE + l
    return np.broadcast_to(dest, real.shape)[real]


def window_rows(rs: RouteStream) -> np.ndarray:
    """(2, n_ywin) int32: the staging rows (region·128 + row, in reduce
    layout) of y window w are [lo[w], hi[w]) (empty where lo == hi); the
    freeze gives each window contiguous rows, in window order.  Raises
    where one window's rows are not contiguous or the windows are out of
    order."""
    n_ywin = rs.y_windows()
    wrow = rs.host("wrow").reshape(-1).astype(np.int64)
    g = np.nonzero(wrow != n_ywin)[0]
    w = wrow[g]
    if w.size and (w.min() < 0 or w.max() > n_ywin):
        raise ValueError("route: wrow names a window outside the matrix")
    if np.any(np.diff(w) < 0) or np.any(np.diff(g)[np.diff(w) == 0] != 1):
        raise ValueError("route: a y window's staging rows are not contiguous")
    lo = np.zeros(n_ywin, np.int64)
    hi = np.zeros(n_ywin, np.int64)
    if w.size:
        first = np.concatenate([[True], w[1:] != w[:-1]])
        last = np.concatenate([w[1:] != w[:-1], [True]])
        lo[w[first]] = g[first]
        hi[w[last]] = g[last] + 1
    return np.stack([lo, hi]).astype(np.int32)


# --- the kernel ------------------------------------------------------------------

def launch(plan: _rowgroup.Plan, split: _rowgroup.MergeSplit, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through ``route_spmv_kernel`` over ``split`` of the G = 1
    ``plan``, one launch (counted in ``_rowgroup.LAUNCHES["route_spmv"]``);
    x (n_cols,) on the plan's CUDA device.  bf16/f16 values and x are
    computed in f32."""
    n_rows = plan.shape[0]
    adt = accum_dtype(torch.promote_types(plan.vals.dtype, x.dtype))
    vals = plan.vals_as(adt)
    xc = x.to(adt).contiguous()
    y = torch.empty(n_rows, dtype=adt, device=x.device)
    if n_rows == 0:
        return y
    stream = torch.cuda.current_stream(x.device)
    partial, tickets = split.scratch(stream, adt)
    lib = _kernels()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"smt_route_spmv_{_SUFFIX[adt]}")(
            plan.grp_ptr.data_ptr(), plan.cols.data_ptr(), vals.data_ptr(),
            split.starts.data_ptr(), split.tile_span.data_ptr(), split.spans.data_ptr(),
            split.n_tiles, split.items, xc.data_ptr(), y.data_ptr(),
            partial.data_ptr() if partial is not None else None, tickets.data_ptr(),
            stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"route_spmv: CUDA error {rc} "
                           f"({lib.smt_route_error_string(rc).decode()})")
    _rowgroup.LAUNCHES["route_spmv"] += 1
    return y


# --- the kernel's order, in plain torch (for the tests) -----------------------------

def route_spmv_walk(plan: _rowgroup.Plan, split: _rowgroup.MergeSplit,
                    x: torch.Tensor) -> torch.Tensor:
    """y = A @ x by ``route_spmv_kernel``'s arithmetic in its order, in
    plain torch, over ``split`` of the G = 1 ``plan``: each product
    rounded, each thread's run of merge items summed from 0 in order, the
    open sums scanned Hillis-Steele by key, the first row a thread closes
    given the scan of the thread before, and a spanning row's per-tile
    partials added from 0 in tile order."""
    adt = accum_dtype(torch.promote_types(plan.vals.dtype, x.dtype))
    dev = x.device
    n_rows, nnz = plan.n_groups, plan.n_union
    y = torch.zeros(plan.shape[0], dtype=adt, device=dev)
    if split.n_tiles == 0:
        return y
    prod = torch.cat([plan.vals[0].to(adt) * x.to(adt)[plan.cols.long()],
                      torch.zeros(1, dtype=adt, device=dev)])
    end = plan.grp_ptr[1:]
    ipt = split.ipt
    n_thr = -(-split.items // ipt)                     # threads of a full tile that hold items
    d0 = split.starts[:-1].sum(1)
    d1 = split.starts[1:].sum(1)
    u = torch.arange(n_thr, device=dev)
    d = torch.minimum(d0[:, None] + u * ipt, d1[:, None])       # (n_tiles, n_thr)
    d_end = torch.minimum(d + ipt, d1[:, None])
    i = torch.searchsorted(end + torch.arange(n_rows, device=dev), d)
    j = d - i
    run = torch.zeros(d.shape, dtype=adt, device=dev)
    first_sum = torch.zeros_like(run)
    first_row = torch.full(d.shape, -1, dtype=torch.int64, device=dev)
    for k in range(ipt):
        live = d + k < d_end
        closes = live & (i < n_rows) & (end[i.clamp(max=max(n_rows - 1, 0))] <= j)
        adds = live & ~closes
        later = closes & (first_row >= 0)
        y[i[later]] = run[later]
        first = closes & (first_row < 0)
        first_sum = torch.where(first, run, first_sum)
        first_row = torch.where(first, i, first_row)
        run = torch.where(closes, torch.zeros_like(run), run)
        run = torch.where(adds, run + prod[j.clamp(max=nnz)], run)
        i, j = i + closes, j + adds
    off = 1
    while off < n_thr:                                  # the segmented scan
        back = (u - off).clamp(min=0)
        same = (u >= off) & (i[:, back] == i)
        run = torch.where(same, run[:, back] + run, run)
        off <<= 1
    back = (u - 1).clamp(min=0)
    v = torch.where((u > 0) & (i[:, back] == first_row), run[:, back] + first_sum, first_sum)
    tile = torch.arange(split.n_tiles, device=dev)[:, None].expand(d.shape)
    span0 = split.tile_span[:, 0].long()[:, None].expand(d.shape)
    to_part = (first_row >= 0) & (first_row == split.starts[:-1, 0][:, None]) & (span0 >= 0)
    direct = (first_row >= 0) & ~to_part
    y[first_row[direct]] = v[direct]
    spans = split.spans.long()
    partial = torch.zeros(split.n_partial, dtype=adt, device=dev)
    s = span0[to_part]
    partial[spans[s, 3] + tile[to_part] - spans[s, 1]] = v[to_part]
    last = -(-(d1 - d0) // ipt) - 1                     # the last thread that holds items
    s1 = split.tile_span[:, 1].long()
    on = s1 >= 0
    partial[spans[s1[on], 3] + tile[on, 0] - spans[s1[on], 1]] = \
        run[tile[on, 0], last[on]]
    sums = torch.zeros(split.n_span, dtype=adt, device=dev)
    for k in range(split.longest):
        on = spans[:, 2] > k
        sums[on] = sums[on] + partial[spans[on, 3] + k]
    y[spans[:, 0]] = sums
    return y
