"""RouteStream SpMV: the two CUDA kernels' wrappers, their plain versions
and launch counters (counterpart of ``sparsemat_tpu/kernels/route.py``).

The SpMV is two launches, as on the TPU: ``route_gather`` (products routed
into the staging buffer) and ``route_reduce`` (staging segments summed into
y).  The CUDA kernels live in ``csrc/route.cu`` (see the note there for
what they replace and what bounds them).  The plain versions replay the
JAX package's table semantics (``route_spmv_xla``) with tensor ops,
vectorised over supertiles and regions where the JAX package scans, so the
kernels and the plain versions are independent.

Dtypes: the values and the float tables (``m1``, ``pmask``, ``segmask``)
are cast to the accumulation dtype of values and x (bf16/f16 to f32) before
the launch; the kernels run in f32 or f64.  A wrapper takes the plain
version only when its tensors lie on the CPU; on a CUDA tensor it launches
its kernel or raises.  The layout is checked once per matrix, and the
launch plan cached on it (``_plan``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.route import ARRAYS, FLOAT_ARRAYS, LANE, REG_ROWS, SUP_ROWS, RouteStream
from ..types import FLOAT_DTYPES, accum_dtype
from .._build import load_cuda

#: kernel launches (plain versions do not count)
LAUNCHES = {"route_gather": 0, "route_reduce": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/route.cu`` library."""
    global _lib
    if _lib is None:
        lib = load_cuda("route")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_route_gather_{s}")
            fn.argtypes = [vp] * 8 + [i32, i32, i64, vp, vp, i64, vp]
            fn.restype = i32
            fn = getattr(lib, f"smt_route_reduce_{s}")
            fn.argtypes = [vp] * 10 + [i32, i64, vp, vp]
            fn.restype = i32
        lib.smt_route_error_string.argtypes = [i32]
        lib.smt_route_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def staging_rows(rs: RouteStream) -> int:
    """Rows of the staging buffer: the regions' rows plus one spare region
    that unused ``touch`` entries name."""
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


# --- the layout's invariants (the kernels rely on them) --------------------------

def slot_owners(rs: RouteStream) -> np.ndarray:
    """The staging slot (row·128 + lane) that each real product of the
    gather lands on, from the host tables: for arrival slot (j, l) of each
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
    layout) of y window w are [lo[w], hi[w]) (empty where lo == hi).
    Raises where one window's rows are not contiguous or the windows are
    out of order."""
    n_ywin = rs.y_windows()
    wrow = rs.host("wrow").reshape(-1).astype(np.int64)
    g = np.nonzero(wrow != n_ywin)[0]
    w = wrow[g]
    if w.size and (w.min() < 0 or w.max() > n_ywin):
        raise ValueError("route: wrow names a window outside the matrix")
    if np.any(np.diff(w) < 0) or np.any(np.diff(g)[np.diff(w) == 0] != 1):
        raise ValueError("route_reduce: a y window's staging rows are not "
                         "contiguous; the kernel sums each window's rows in one pass")
    lo = np.zeros(n_ywin, np.int64)
    hi = np.zeros(n_ywin, np.int64)
    if w.size:
        first = np.concatenate([[True], w[1:] != w[:-1]])
        last = np.concatenate([w[1:] != w[:-1], [True]])
        lo[w[first]] = g[first]
        hi[w[last]] = g[last] + 1
    return np.stack([lo, hi]).astype(np.int32)


def _check_layout(rs: RouteStream) -> None:
    """Raise on a RouteStream the kernels do not take: arrays on several or
    non-CUDA devices, wrong dtypes or shapes, table entries out of range, or
    a staging slot that two real products share (the gather stores each
    product, it does not add)."""
    dev = rs.a_vals.device
    ts = {k: getattr(rs, k) for k in ARRAYS}
    if dev.type != "cuda" or any(t.device != dev for t in ts.values()):
        raise ValueError(f"route: the kernels need every array on one CUDA device, got {dev}")
    if rs.dtype not in FLOAT_DTYPES:
        raise TypeError(f"route: the CUDA kernels take float values, got {rs.dtype}")
    if any(ts[k].dtype != rs.dtype for k in FLOAT_ARRAYS):
        raise TypeError("route: m1, pmask and segmask must have the values' dtype")
    if any(ts[k].dtype != torch.int32 for k in ARRAYS if k not in FLOAT_ARRAYS):
        raise TypeError("route: the index tables must be int32")
    if not all(t.is_contiguous() for t in ts.values()):
        raise ValueError("route: the kernels need contiguous arrays")
    n_sup, n_spl, n_reg = rs.n_sup, rs.n_splits, rs.n_regions
    want = {"a_vals": (n_sup * SUP_ROWS, LANE), "a_lidx": (n_sup * SUP_ROWS, LANE),
            "a_win": (n_sup * SUP_ROWS,), "a_rows": (n_sup * SUP_ROWS, LANE),
            "touch": (n_sup, n_spl, SUP_ROWS), "wrow": (n_reg, REG_ROWS)}
    want.update({k: (n_sup, n_spl, SUP_ROWS, LANE) for k in ("p1", "m1", "p2", "p3")})
    want.update({k: (n_reg, REG_ROWS, LANE)
                 for k in ("q1", "q2", "q3", "lpos", "ppos", "pmask", "segmask")})
    for k, shp in want.items():
        if tuple(ts[k].shape) != shp:
            raise ValueError(f"route: {k} has shape {tuple(ts[k].shape)}, the layout "
                             f"needs {shp}")
    for k in ("a_lidx", "p1", "p2", "p3", "q1", "q2", "q3", "lpos", "ppos"):
        h = rs.host(k)
        if h.size and (h.min() < 0 or h.max() >= LANE):
            raise ValueError(f"route: {k} holds a lane outside [0, 128)")
    touch = rs.host("touch")
    if touch.min() < 0 or touch.max() >= staging_rows(rs):
        raise ValueError("route: touch names a row outside the staging buffer")
    if rs.host("a_win").min() < 0:
        raise ValueError("route: a_win holds a negative window")
    owners = slot_owners(rs)
    if np.unique(owners).size != owners.size:
        raise ValueError("route_gather: two real products share a staging slot")


class _Plan:
    """What the launches need besides x, built once per matrix after its
    layout is checked: each window's staging-row bounds on the device, and
    the float arrays cast to each accumulation dtype met so far."""

    def __init__(self, rs: RouteStream):
        _check_layout(rs)
        bounds = window_rows(rs)
        dev = rs.a_vals.device
        self.win_lo = torch.from_numpy(bounds[0]).to(dev)
        self.win_hi = torch.from_numpy(bounds[1]).to(dev)
        self._floats = {rs.dtype: {k: getattr(rs, k) for k in FLOAT_ARRAYS}}

    def floats(self, rs: RouteStream, adt: torch.dtype) -> dict:
        """a_vals, m1, pmask and segmask in ``adt`` (cast once, then kept)."""
        if adt not in self._floats:
            self._floats[adt] = {k: getattr(rs, k).to(adt).contiguous()
                                 for k in FLOAT_ARRAYS}
        return self._floats[adt]


def _plan(rs: RouteStream) -> _Plan:
    """The matrix's launch plan, cached on it (a frozen matrix's layout and
    values never change)."""
    plan = rs.__dict__.get("_route_plan")
    if plan is None:
        plan = _Plan(rs)
        object.__setattr__(rs, "_route_plan", plan)
    return plan


def _on_cpu(rs: RouteStream, t: torch.Tensor) -> bool:
    return t.device.type == "cpu" and rs.a_vals.device.type == "cpu"


def _check_operand(rs: RouteStream, t: torch.Tensor, what: str) -> None:
    if t.device != rs.a_vals.device:
        raise ValueError(f"{what}: matrix on {rs.a_vals.device} and operand on "
                         f"{t.device}; the kernel needs both on one CUDA device")
    if t.dtype not in FLOAT_DTYPES:
        raise TypeError(f"{what}: the CUDA kernel takes a float operand, got {t.dtype}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernels().smt_route_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def route_gather(rs: RouteStream, x: torch.Tensor) -> torch.Tensor:
    """The staging buffer of ``route_gather_ref``.  CUDA: one launch of
    ``route_gather_kernel`` (after zeroing the buffer on the stream); the
    spare rows past the regions stay zero.  CPU: the plain version."""
    if _on_cpu(rs, x):
        return route_gather_ref(rs, x)
    plan = _plan(rs)
    _check_operand(rs, x, "route_gather")
    if x.dim() != 1 or x.shape[0] != rs.shape[1]:
        raise ValueError(f"route_gather: vector of shape {tuple(x.shape)} for a "
                         f"{rs.shape} matrix")
    adt = _adt(rs, x)
    x = x.to(adt).contiguous()
    fl = plan.floats(rs, adt)
    staging = torch.empty(staging_rows(rs), LANE, dtype=adt, device=x.device)
    lib = _kernels()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"smt_route_gather_{_SUFFIX[adt]}")(
            fl["a_vals"].data_ptr(), rs.a_lidx.data_ptr(), rs.a_win.data_ptr(),
            rs.p1.data_ptr(), fl["m1"].data_ptr(), rs.p2.data_ptr(), rs.p3.data_ptr(),
            rs.touch.data_ptr(), rs.n_sup, rs.n_splits, rs.shape[1], x.data_ptr(),
            staging.data_ptr(), staging.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "route_gather")
    LAUNCHES["route_gather"] += 1
    return staging


def route_reduce(rs: RouteStream, staging: torch.Tensor) -> torch.Tensor:
    """y = the segment sums of ``staging`` (``route_reduce_ref``).  CUDA:
    one launch of ``route_reduce_kernel``, one CTA per y window summing its
    staging rows in order; CPU: the plain version."""
    if _on_cpu(rs, staging):
        return route_reduce_ref(rs, staging)
    plan = _plan(rs)
    _check_operand(rs, staging, "route_reduce")
    adt = staging.dtype
    if adt not in _SUFFIX:
        raise TypeError(f"route_reduce: staging must be f32 or f64, got {adt}")
    if tuple(staging.shape) != (staging_rows(rs), LANE) or not staging.is_contiguous():
        raise ValueError(f"route_reduce: staging of shape {tuple(staging.shape)}, the "
                         f"layout needs a contiguous ({staging_rows(rs)}, {LANE})")
    fl = plan.floats(rs, adt)
    n_rows = rs.shape[0]
    y = torch.empty(n_rows, dtype=adt, device=staging.device)
    lib = _kernels()
    with torch.cuda.device(staging.device):
        rc = getattr(lib, f"smt_route_reduce_{_SUFFIX[adt]}")(
            staging.data_ptr(), rs.q1.data_ptr(), rs.q2.data_ptr(), rs.q3.data_ptr(),
            rs.lpos.data_ptr(), rs.ppos.data_ptr(), fl["pmask"].data_ptr(),
            fl["segmask"].data_ptr(), plan.win_lo.data_ptr(), plan.win_hi.data_ptr(),
            rs.y_windows(), n_rows, y.data_ptr(),
            torch.cuda.current_stream(staging.device).cuda_stream)
    _raise_on(rc, "route_reduce")
    LAUNCHES["route_reduce"] += 1
    return y


def route_spmv(rs: RouteStream, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  CUDA: ``route_gather`` then ``route_reduce`` (two
    launches); CPU: the plain version."""
    return route_reduce(rs, route_gather(rs, x))
