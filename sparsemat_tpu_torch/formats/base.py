"""Shared machinery for frozen sparse formats (counterpart of
``sparsemat_tpu/formats/base.py``).

Formats are frozen dataclasses of tensors on one explicit device; ops and
solvers are plain functions on them.  Freezes run on the host in numpy and
upload once at the end; a format built that way keeps its host arrays in a
cache (``host()``), so later host-side conversions never read the device
back.

Padding convention (shared with the JAX package): structure arrays may
carry *tail padding*.  A padded entry has ``row == n_rows``, ``col == 0``
and ``val == 0``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..types import accum_dtype, as_torch_dtype, compute_index_dtype

Shape = Tuple[int, int]


def to_device(arr, dtype=None, device=None) -> torch.Tensor:
    """Host array → tensor of ``dtype`` on ``device`` (one upload)."""
    t = torch.from_numpy(np.require(np.asarray(arr), requirements=["C", "W"]))
    if dtype is not None:
        t = t.to(as_torch_dtype(dtype))
    return t.to(device) if device is not None else t


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy (bf16, which numpy lacks, as f32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class SparseFormat:
    """Mixin providing the operator surface (``@`` with a vector, a dense
    matrix or a sparse matrix, ``+``, ``-``, ``*`` by a scalar, ``T``,
    ``mvp``) and the structure queries every format shares."""

    shape: Shape

    # -- host-side array cache -----------------------------------------------
    def _stash_host(self, **arrays) -> "SparseFormat":
        object.__setattr__(
            self, "_host_cache", {k: np.asarray(v) for k, v in arrays.items()})
        return self

    def host(self, name: str) -> np.ndarray:
        """Field ``name`` as a numpy array, cached across calls."""
        cache = self.__dict__.get("_host_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_host_cache", cache)
        if name not in cache:
            cache[name] = _numpy(getattr(self, name))
        return cache[name]

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        raise NotImplementedError

    def to_csr(self):
        raise NotImplementedError

    def to_dia(self):
        from .dia import DIA

        return DIA.from_csr(self.to_csr())

    def to_strip(self, n_classes: int = 32, group: int = 16,
                 lidx_pack: int = 4):
        from .strip import StripELL

        return StripELL.from_csr(self.to_csr(), n_classes=n_classes,
                                 group=group, lidx_pack=lidx_pack)

    def to_route(self):
        from .route import RouteStream

        return RouteStream.from_csr(self.to_csr())

    def to_ell(self, n_cols_per_row: int | None = None):
        return self.to_csr().to_ell(n_cols_per_row=n_cols_per_row)

    def to_slab(self, rb: int | None = None):
        from .slab import SLAB_ROW_BLOCK, SlabELL

        return SlabELL.from_csr(self.to_csr(), rb=rb or SLAB_ROW_BLOCK)

    def to_slab_pack(self, rb: int | None = None, n_classes: int = 8):
        from .slab import SLAB_ROW_BLOCK, SlabPack

        return SlabPack.from_csr(self.to_csr(), rb=rb or SLAB_ROW_BLOCK,
                                 n_classes=n_classes)

    def to_slab_stream(self, rb: int | None = None):
        from .slab import SLAB_ROW_BLOCK, SlabStream

        return SlabStream.from_csr(self.to_csr(), rb=rb or SLAB_ROW_BLOCK)

    def to_well(self, k_tile: int | None = None):
        from .well import WELL

        return WELL.from_csr(self.to_csr(), k_tile=k_tile)

    def to_sell(self, slice_height: int = 8):
        from .sell import SELL

        return SELL.from_csr(self.to_csr(), slice_height=slice_height)

    def to_gell(self, k0: int | None = None):
        from .gell import GELL

        return GELL.from_csr(self.to_csr(), k0=k0)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype  # type: ignore[attr-defined]

    @property
    def device(self) -> torch.device:
        return self.data.device  # type: ignore[attr-defined]

    @property
    def index_dtype(self):
        raise NotImplementedError

    # -- algebra ----------------------------------------------------------------
    def __matmul__(self, other):
        from ..ops import spgemm, spmm, spmv

        if isinstance(other, SparseFormat):
            return spgemm(self, other)
        other = torch.as_tensor(other)
        if other.dim() == 1:
            return spmv(self, other)
        if other.dim() == 2:
            return spmm(self, other)
        raise ValueError(f"cannot multiply sparse matrix by array of rank {other.dim()}")

    def mvp(self, x):
        """SpMV — name kept from the reference library."""
        from ..ops import spmv

        return spmv(self, torch.as_tensor(x))

    def __add__(self, other):
        from ..ops import add

        return add(self, other)

    def __sub__(self, other):
        from ..ops import sub

        return sub(self, other)

    def __mul__(self, scalar):
        return self.scale(scalar)

    def __rmul__(self, scalar):
        return self.scale(scalar)

    def scale(self, scalar):
        raise NotImplementedError

    @property
    def T(self):
        from ..ops import transpose

        return transpose(self)

    def transpose(self):
        from ..ops import transpose

        return transpose(self)

    def inner_prod(self, l, r):
        """Bilinear form lᵀ A r (``ops.inner_prod``)."""
        from ..ops import inner_prod

        return inner_prod(self, l, r)

    def astype(self, dtype) -> "SparseFormat":
        """Same structure, values cast to ``dtype``: floating tensor fields
        only; index and mask fields keep their types (the mixed-precision
        solvers' low-precision operator)."""
        dtype = as_torch_dtype(dtype)
        updates = {}
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            t = getattr(self, f.name)
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                updates[f.name] = t.to(dtype)
        return dataclasses.replace(self, **updates)  # type: ignore[type-var]

    # -- performance model ------------------------------------------------------
    #: tensor fields one SpMV streams; None means every tensor field.  Formats
    #: name theirs where bookkeeping arrays (a CSR's indptr, a WELL's
    #: row_cnt) are never read by the product, as the JAX package does.
    _spmv_read_fields: Tuple[str, ...] | None = None

    def spmv_traffic_bytes(self) -> int:
        """The layout's bytes for one SpMV (the JAX package's count): every
        array the product streams, padding slots included, read once, x
        read once and y written once."""
        fields = self._spmv_read_fields
        if fields is None:
            fields = tuple(f.name for f in dataclasses.fields(self))  # type: ignore[arg-type]
        total = 0
        for name in fields:
            t = getattr(self, name)
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
        x_bytes = self.shape[1] * self.dtype.itemsize
        y_bytes = self.shape[0] * accum_dtype(self.dtype).itemsize
        return int(total + x_bytes + y_bytes)

    # -- structure queries ------------------------------------------------------
    @property
    def nse(self) -> int:
        """Number of stored entry *slots* (incl. tail padding)."""
        raise NotImplementedError

    def n_non_zero_entries(self) -> int:
        raise NotImplementedError

    def density(self) -> float:
        """Stored entries / (n_rows * n_cols)."""
        return self.n_non_zero_entries() / float(self.n_rows * self.n_cols)

    def sparsity(self) -> float:
        return 1.0 - self.density()

    def todense(self) -> torch.Tensor:
        coo = self.to_coo()
        valid = coo.rows.long() < self.n_rows
        out = torch.zeros(self.shape, dtype=self.dtype, device=coo.vals.device)
        return out.index_put_((coo.rows.long()[valid], coo.cols.long()[valid]),
                              coo.vals[valid], accumulate=True)

    # -- host-side point access (the JAX package's, through to_csr / to_coo) --
    def __iter__(self):
        """(row, col, val) over the stored entries, row-major and column-
        sorted within a row, skipping empty rows."""
        csr = self.to_csr()
        indptr = csr.host("indptr")
        indices = csr.host("indices")
        data = csr.host("data")
        for i in range(csr.n_rows):
            for p in range(int(indptr[i]), int(indptr[i + 1])):
                yield i, int(indices[p]), data[p]

    def get(self, i: int, j: int):
        """A[i, j] as a numpy scalar: the sum of the stored entries at
        (i, j), 0 where there is none.  O(nse) on the host."""
        coo = self.to_coo()
        r, c, v = (_numpy(t) for t in (coo.rows, coo.cols, coo.vals))
        hit = (r == i) & (c == j)
        return v[hit].sum() if hit.any() else v.dtype.type(0)

    def __getitem__(self, ij):
        i, j = ij
        return self.get(i, j)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(shape={self.shape}, nse={self.nse}, "
                f"dtype={self.dtype}, device={self.device})")


# --- canonicalization helpers (tensor ops, any device) ------------------------

def sort_coo(rows, cols, vals, shape: Shape):
    """Sort COO triplets into canonical row-major, column-sorted order.
    One stable sort on the fused key ``row·(n_cols+1) + col`` (fits int64
    for any int32 shape); duplicates keep their input order, and padding
    (row == n_rows) sorts to the tail."""
    key = rows.long() * (int(shape[1]) + 1) + cols.long()
    order = torch.sort(key, stable=True).indices
    return rows[order], cols[order], vals[order]


def dedup_sorted_coo(rows, cols, vals, shape: Shape):
    """Sum duplicate coordinates in a *sorted* COO stream, keeping the array
    size: survivors are compacted to the front, vacated slots become tail
    padding.  Returns (rows, cols, vals, n_unique).  The sums are a
    row-segmented reduction (no atomics), so reruns are bitwise equal."""
    n_rows = int(shape[0])
    nse = rows.shape[0]
    if nse == 0:
        return rows, cols, vals, 0
    r = rows.long()
    c = cols.long()
    new = torch.ones(nse, dtype=torch.bool, device=rows.device)
    new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    starts = torch.nonzero(new).flatten()
    n_groups = int(starts.shape[0])
    offsets = torch.cat([starts, torch.tensor([nse], device=rows.device)])
    summed = torch.segment_reduce(vals.to(accum_dtype(vals.dtype)), "sum",
                                  offsets=offsets, unsafe=True).to(vals.dtype)
    gr = r[starts]
    gpad = gr >= n_rows
    out_rows = torch.full((nse,), n_rows, dtype=rows.dtype, device=rows.device)
    out_cols = torch.zeros((nse,), dtype=cols.dtype, device=cols.device)
    out_vals = torch.zeros((nse,), dtype=vals.dtype, device=vals.device)
    out_rows[:n_groups] = torch.where(gpad, n_rows, gr).to(rows.dtype)
    out_cols[:n_groups] = torch.where(gpad, 0, c[starts]).to(cols.dtype)
    out_vals[:n_groups] = torch.where(gpad, torch.zeros_like(summed), summed)
    return out_rows, out_cols, out_vals, int((~gpad).sum())


def rows_to_indptr(rows, n_rows: int, index_dtype=None):
    """Sorted row ids → CSR indptr (bincount + cumsum; padding rows fall in
    the dropped tail bucket)."""
    counts = torch.bincount(rows.long().clamp(0, n_rows),
                            minlength=n_rows + 1)[:n_rows]
    indptr = torch.cat([torch.zeros(1, dtype=counts.dtype, device=rows.device),
                        torch.cumsum(counts, 0)])
    dt = index_dtype if index_dtype is not None else compute_index_dtype(rows.dtype)
    return indptr.to(as_torch_dtype(dt))


def indptr_to_rows(indptr, nse: int, index_dtype=None):
    """CSR indptr → per-entry row ids (searchsorted; padding tail → n_rows)."""
    n_rows = indptr.shape[0] - 1
    ip = indptr.long()
    pos = torch.arange(nse, device=indptr.device)
    row_ids = torch.searchsorted(ip[1:], pos, right=True)
    row_ids = torch.where(pos < ip[-1], row_ids, n_rows)
    dt = index_dtype if index_dtype is not None else indptr.dtype
    return row_ids.to(as_torch_dtype(dt))
