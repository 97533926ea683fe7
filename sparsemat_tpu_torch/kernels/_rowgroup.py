"""The row-group SpMM shared by the BSR and slab wrappers: a compact launch
plan built once per matrix, the CUDA kernel's binding (``csrc/spmm.cu``,
see the note there for what it replaces and what bounds it), and a plain
walk of the plan in the kernel's order.

The plan holds exactly the entries the format's own ``to_coo`` counts
(stored zeros stay, zero blocks and padding slots go), whose row and
column lie inside the matrix.  Rows are cut into groups of G consecutive
rows (G ≤ 8, the same for the whole matrix); each group keeps one sorted
list of the union of its rows' columns, and each row one value per union
column (zero where it has no entry) beside a bit that says whether it has
one.  G is chosen per matrix, with no argument, to minimise the bytes one
column tile of the product reads: the plan's columns, masks and values,
and one 512-byte B slice per union column.  On a dof-blocked FEM operator
the dof rows of a node share their columns and G comes out at the dof
count; on a scattered matrix groups of 1 win, which are plain compact
rows.  A row with two entries at one column (which no freeze makes) gets
a union column for each, so every entry is its own term.

The plan lives beside the format (the frozen layouts stay bit-equal to
the JAX freezes); its code is plain torch on any device, so the CPU tests
build and walk it.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_cuda
from ..types import accum_dtype

#: the largest row group (the kernel's mask is 8 bits)
MAX_GROUP = 8
#: bytes of B a warp gathers per union column at a full column tile
_TILE_BYTES = 512
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/spmm.cu`` library."""
    global _lib
    if _lib is None:
        lib = load_cuda("spmm")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_rowgroup_spmm_{s}")
            fn.argtypes = [vp, vp, vp, vp, i64, i64, i32, i64, i64, vp, vp, i32, vp]
            fn.restype = i32
        lib.smt_spmm_error_string.argtypes = [i32]
        lib.smt_spmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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

    def vals_as(self, dtype: torch.dtype) -> torch.Tensor:
        """The values in ``dtype``, cast once and kept."""
        if dtype not in self._cast:
            self._cast[dtype] = self.vals.to(dtype)
        return self._cast[dtype]


def build(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, shape) -> Plan:
    """The plan of the entries (rows, cols, vals), in any order, on their
    device; entries outside the matrix are dropped."""
    n_rows, n_cols = (int(s) for s in shape)
    dev = vals.device
    vdt = accum_dtype(vals.dtype)
    rows, cols = rows.long(), cols.long()
    keep = (rows >= 0) & (rows < n_rows) & (cols >= 0) & (cols < n_cols)
    rows, cols, vals = rows[keep], cols[keep], vals[keep].to(vdt)
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


def walk(plan: Plan, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B by the kernel's arithmetic in its order, in plain torch:
    each row's terms summed over its group's union columns in order, a
    masked-off term skipped.  For the tests (the wrappers' plain versions
    are the formats' own)."""
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


def launch(plan: Plan, B: torch.Tensor, launches: dict, name: str) -> torch.Tensor:
    """Y = A @ B through ``rowgroup_spmm_kernel``, one launch (counted in
    ``launches[name]``); B (n_cols, m) on the plan's CUDA device.  bf16/f16
    values and B are computed in f32."""
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
    lib = _kernels()
    with torch.cuda.device(B.device):
        rc = getattr(lib, f"smt_rowgroup_spmm_{_SUFFIX[adt]}")(
            plan.grp_ptr.data_ptr(), plan.cols.data_ptr(), plan.mask.data_ptr(),
            vals.data_ptr(), plan.n_union, plan.n_groups, plan.group, n_rows, m,
            Bc.data_ptr(), Y.data_ptr(), vec, torch.cuda.current_stream(B.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} ({lib.smt_spmm_error_string(rc).decode()})")
    launches[name] += 1
    return Y
