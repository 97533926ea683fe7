"""Row-partitioned distributed sparse matrices (counterpart of
``sparsemat_tpu/parallel/dist.py``).

The JAX package's contiguous block-row decomposition over a
``torch.distributed`` job: the rank at coordinate i of a 1-D mesh
(``mesh.py``) holds row block i, and a vector partitioned by rows is a
``DTensor`` placed ``[Shard(0)]`` over the padded rows.

* ``DistDIA``: banded matrices.  Each rank sends its h edge rows of x to
  both neighbours (with wrap-around, as ``ppermute`` does; the wrapped rows
  meet only zero diagonal slots) and runs ``dia_spmv_kernel`` once over
  the rectangular band ``DIA(block, offsets + h, shape=(r, r + 2h))``,
  made once per matrix.  A halo wider than a block all-gathers x and runs
  the same kernel over ``(r, padded rows)``, the offsets shifted by the
  block's first row.
* ``DistCSR`` / ``DistELL``: x is all-gathered, then one launch of
  ``rowgroup_spmv_kernel`` over the shard's row-group plan
  (``kernels/_rowgroup.py``), built once from its stored entries.
* ``DistCSRSubset``: n − 1 hops, hop k sending each rank's subset of x to
  the rank k ahead, padded to that hop's own largest subset; then the same
  kernel over the shard's plan, whose columns are renumbered into [own x |
  hop 1 | hop 2 | ...].
* ``DistSlab``: the scattered analogue of DistDIA's halo, in whole
  128-column windows; the shard product is ``ops/matvec.py``
  ``planned_spmv`` over the rank's local SlabELL, made once per matrix, so
  its plan is built once.

Each format's host partition (``partition_*``) is a pure numpy function of
the frozen matrix and the block count that returns every block: the JAX
package's global arrays, array for array and bit for bit.  ``distribute_*``
keeps the rank's block and uploads it.

The shard products see plain local tensors: ``dist_*_spmv`` takes x's local
part, exchanges, launches and wraps y as a ``Shard(0)`` DTensor.  The
solvers' dots (``torch.sum`` of two sharded vectors) come out as
``Partial(sum)`` DTensors and are all-reduced where they are read, as
GSPMD's psum is in the JAX package.  No product sums with atomics and the
collectives move values without summing them, so reruns on one mesh are
bitwise equal.  On CPU tensors the shard products take the kernels' plain
versions (``dia_spmv_ref``, ``_rowgroup.spmv_walk``, ``slab_spmv_ref``).
``LAUNCHES`` counts the shard products' kernel launches, where each kernel
launches (the kernels' own counters do not see them).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..formats.base import to_device
from ..formats.csr import CSR
from ..formats.dia import DIA
from ..formats.slab import SLAB_ROW_BLOCK, WINDOW, SlabELL
from ..kernels import _rowgroup
from ..kernels import dia as kd
from ..ops.matvec import planned_spmv
from ..utils import profiling
from .mesh import ROWS_AXIS, mesh_device

#: shard products that launched their kernel (plain versions do not count)
LAUNCHES = profiling.register("parallel.dist", {
    "dist_dia_spmv": 0, "dist_csr_spmv": 0, "dist_ell_spmv": 0, "dist_csr_subset_spmv": 0,
    "dist_slab_spmv": 0})


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pad_rows(n_rows: int, n_blocks: int) -> int:
    return -(-n_rows // n_blocks) * n_blocks


# --- the mesh: this rank's block, exchanges ---------------------------------------

def _n_blocks(mesh: DeviceMesh, axis: str) -> int:
    if mesh.ndim != 1 or mesh.mesh_dim_names != (axis,):
        raise ValueError(f"a row partition needs a 1-D mesh over {axis!r}, got the axes "
                         f"{mesh.mesh_dim_names}")
    return mesh.size()


def _shift(mesh: DeviceMesh, sends):
    """For each (tensor, k) of ``sends``: send the tensor to the rank k
    ahead on the ring of the mesh and receive one of the same size from the
    rank k behind (``lax.ppermute`` by k).  The ops go out in one batch,
    sends and receives in the order of ``sends`` on every rank, each pair
    tagged by its place, so two messages between one pair of ranks never
    cross."""
    ranks = mesh.mesh.flatten().tolist()
    n, me = len(ranks), mesh.get_local_rank()
    group = mesh.get_group()
    ops, received = [], []
    for tag, (t, k) in enumerate(sends):
        buf = torch.empty_like(t)
        received.append(buf)
        ops.append(dist.P2POp(dist.isend, t.contiguous(), ranks[(me + k) % n], group, tag))
        ops.append(dist.P2POp(dist.irecv, buf, ranks[(me - k) % n], group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return received


def _all_gather(mesh: DeviceMesh, xl: torch.Tensor) -> torch.Tensor:
    """Every rank's block of x, in mesh order (the group orders its ranks
    by number, which a host-major mesh need not)."""
    group = mesh.get_group()
    n = mesh.size()
    out = torch.empty(n * xl.shape[0], dtype=xl.dtype, device=xl.device)
    dist.all_gather_into_tensor(out, xl.contiguous(), group=group)
    ranks = mesh.mesh.flatten().tolist()
    order = [dist.get_group_rank(group, g) for g in ranks]
    if order != list(range(n)):
        out = out.view(n, -1)[torch.tensor(order, device=out.device)].reshape(-1)
    return out


class _RowPartitioned:
    """What every row-partitioned format shares: the mesh, this rank's
    block, the sharded vectors."""

    @property
    def n_blocks(self) -> int:
        return self.mesh.size()

    @property
    def padded_rows(self) -> int:
        return self.n_blocks * self.rows_per_block

    @property
    def rank(self) -> int:
        """This process's coordinate on the mesh: the row block it holds."""
        return self.mesh.get_local_rank()

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    def _check_mesh(self, mesh) -> None:
        if mesh is not None and mesh is not self.mesh and mesh != self.mesh:
            raise ValueError("the matrix was distributed over another mesh")

    def padded_vector(self, v, mesh: DeviceMesh | None = None) -> DTensor:
        """A global vector (numpy or tensor, a DTensor read whole) padded to
        the block grid with zeros and sharded by rows: this rank keeps its
        block."""
        self._check_mesh(mesh)
        if isinstance(v, DTensor):
            v = v.full_tensor()
        v = torch.as_tensor(v)
        r, k = self.rows_per_block, self.rank
        local = torch.zeros(r, dtype=v.dtype, device=self.device)
        part = v[k * r: (k + 1) * r]
        local[: part.shape[0]] = part.to(self.device)
        return _sharded(self, local)

    def unpad(self, v):
        """The first n_rows of a padded vector.  On a sharded DTensor the
        slice crosses blocks, so it gathers (as the JAX global slice does):
        read it with ``full_tensor()``."""
        return v[: self.shape[0]]

    def shard_plan(self):
        """The shard product's launch plan, built at first use and kept (on
        the CPU: what the plain version needs, or None).  DistDIA's and
        DistSlab's kernels build and keep theirs on the shard at their
        first launch; this builds it ahead, so it can be timed apart."""
        plan = self.__dict__.get("_shard_plan")
        if plan is None:
            plan = self._make_plan()
            object.__setattr__(self, "_shard_plan", plan)
        return plan


def _sharded(mat: _RowPartitioned, y: torch.Tensor) -> DTensor:
    return DTensor.from_local(y, mat.mesh, [Shard(0)], run_check=False,
                              shape=torch.Size([mat.padded_rows]), stride=(1,))


def _local(mat: _RowPartitioned, x) -> torch.Tensor:
    """This rank's block of x: a DTensor's local part (sharded by rows
    first where it is placed otherwise), or the block's slice of a global
    padded vector."""
    r = mat.rows_per_block
    if isinstance(x, DTensor):
        if tuple(x.placements) != (Shard(0),):
            x = x.redistribute(mat.mesh, [Shard(0)])
        xl = x.to_local()
    else:
        x = torch.as_tensor(x, device=mat.device)
        if x.shape != (mat.padded_rows,):
            raise ValueError(f"a vector of shape {tuple(x.shape)} for {mat.padded_rows} "
                             f"padded rows")
        xl = x[mat.rank * r: (mat.rank + 1) * r]
    if xl.shape != (r,):
        raise ValueError(f"a block of shape {tuple(xl.shape)} for {r} rows a block")
    return xl.contiguous()


def _rank_part(fields: dict, name: str, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a global array, uploaded to its device."""
    a = np.asarray(fields[name])
    if a.shape[0] != mesh.size():
        raise ValueError(f"{name}: {a.shape[0]} blocks for a mesh of {mesh.size()}")
    return to_device(np.ascontiguousarray(a[mesh.get_local_rank()]), None, mesh_device(mesh))


def _plan_spmv(plan, x: torch.Tensor, name: str) -> torch.Tensor:
    """y = A @ x over a shard's row-group plan: one launch of
    ``rowgroup_spmv_kernel`` on CUDA, the walk of the plan in the
    kernel's order on the CPU."""
    if x.device.type == "cpu" and plan.vals.device.type == "cpu":
        return _rowgroup.spmv_walk(plan, x)
    return _rowgroup.launch_spmv(plan, x, LAUNCHES, name)


# --- DistDIA ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DistDIA(_RowPartitioned):
    """Banded matrix, block-row partitioned.  ``data``: (n_diags,
    rows_per_block), this rank's rows of the diagonals; ``offsets``:
    static; ``shape``: global (unpadded).  ``shard``: the rectangular DIA
    the shard product runs (made once)."""

    data: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    axis: str
    mesh: DeviceMesh

    def __post_init__(self):
        r, h = self.rows_per_block, self.halo
        if h <= r:      # x_ext = [h rows of the left block | own r | h of the right]
            offs, width = (o + h for o in self.offsets), r + 2 * h
        else:           # the whole padded x, from the block's first row
            offs, width = (o + self.rank * r for o in self.offsets), self.padded_rows
        object.__setattr__(self, "shard", DIA(data=self.data, offsets=tuple(offs),
                                              shape=(r, width)))

    @classmethod
    def from_global(cls, fields: dict, *, shape, offsets, mesh: DeviceMesh,
                    axis: str = ROWS_AXIS) -> "DistDIA":
        """This rank's part of the global arrays (``data``: (n_blocks,
        n_diags, rows_per_block))."""
        _n_blocks(mesh, axis)
        return cls(data=_rank_part(fields, "data", mesh), offsets=tuple(int(o) for o in offsets),
                   shape=tuple(int(s) for s in shape), axis=axis, mesh=mesh)

    @property
    def rows_per_block(self) -> int:
        return int(self.data.shape[1])

    @property
    def halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    def matvec(self, x, mesh: DeviceMesh | None = None) -> DTensor:
        return dist_dia_spmv(self, x, mesh)

    def _make_plan(self):
        if self.data.device.type == "cpu":
            return None
        return kd.dia_spmv_plan(self.shard, self.data.dtype, self.data.device)


def partition_dia(dia, n_blocks: int) -> dict:
    """The host partition: {"data": (n_blocks, n_diags, rows_per_block)},
    rows padded with zeros to a block multiple."""
    n_rows = dia.shape[0]
    padded = _pad_rows(n_rows, n_blocks)
    data = dia.host("data")
    if padded > n_rows:
        data = np.concatenate(
            [data, np.zeros((data.shape[0], padded - n_rows), data.dtype)], axis=1)
    r = padded // n_blocks
    return {"data": data.reshape(data.shape[0], n_blocks, r).transpose(1, 0, 2)}


def distribute_dia(dia, mesh: DeviceMesh, axis: str = ROWS_AXIS) -> DistDIA:
    """Partition a DIA matrix over the mesh: n_blocks = the mesh's size,
    rows padded to a block multiple; this rank keeps its block."""
    return DistDIA.from_global(partition_dia(dia, _n_blocks(mesh, axis)), shape=dia.shape,
                               offsets=dia.offsets, mesh=mesh, axis=axis)


def dist_dia_spmv(mat: DistDIA, x, mesh: DeviceMesh | None = None) -> DTensor:
    """y = A @ x with the halo exchange.  ``x``: the padded sharded vector
    (``padded_vector``); returns the padded sharded result."""
    mat._check_mesh(mesh)
    xl = _local(mat, x)
    h, r = mat.halo, mat.rows_per_block
    if h > r:
        x_ext = _all_gather(mat.mesh, xl) if mat.n_blocks > 1 else xl
    elif h == 0:
        x_ext = xl
    elif mat.n_blocks == 1:
        x_ext = F.pad(xl, (h, h))
    else:
        left, right = _shift(mat.mesh, [(xl[r - h:], 1), (xl[:h], -1)])
        x_ext = torch.cat([left, xl, right])
    return _sharded(mat, kd.dia_spmv(mat.shard, x_ext, LAUNCHES, "dist_dia_spmv"))


# --- DistCSR / DistELL ------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DistCSR(_RowPartitioned):
    """General sparse matrix, block-row partitioned; column ids are global.
    This rank's ``indptr`` (rows_per_block + 1,) and ``indices`` / ``data``
    / ``local_rows`` (nnz_max,), with tail padding (local row =
    rows_per_block: dropped)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    local_rows: torch.Tensor
    shape: Tuple[int, int]
    axis: str
    mesh: DeviceMesh

    @classmethod
    def from_global(cls, fields: dict, *, shape, mesh: DeviceMesh,
                    axis: str = ROWS_AXIS) -> "DistCSR":
        _n_blocks(mesh, axis)
        return cls(**{f: _rank_part(fields, f, mesh)
                      for f in ("indptr", "indices", "data", "local_rows")},
                   shape=tuple(int(s) for s in shape), axis=axis, mesh=mesh)

    @property
    def rows_per_block(self) -> int:
        return int(self.indptr.shape[0]) - 1

    def matvec(self, x, mesh: DeviceMesh | None = None) -> DTensor:
        return dist_csr_spmv(self, x, mesh)

    def _make_plan(self):
        return _rowgroup.build(self.local_rows, self.indices, self.data,
                               (self.rows_per_block, self.padded_rows))


@dataclasses.dataclass(frozen=True, eq=False)
class DistELL(_RowPartitioned):
    """ELL blocks with global column ids: this rank's ``cols`` / ``vals``
    (rows_per_block, K).  A slot whose value is 0 is padding to the shard
    product (as in a SlabELL without counts)."""

    cols: torch.Tensor
    vals: torch.Tensor
    shape: Tuple[int, int]
    axis: str
    mesh: DeviceMesh

    @classmethod
    def from_global(cls, fields: dict, *, shape, mesh: DeviceMesh,
                    axis: str = ROWS_AXIS) -> "DistELL":
        _n_blocks(mesh, axis)
        return cls(cols=_rank_part(fields, "cols", mesh), vals=_rank_part(fields, "vals", mesh),
                   shape=tuple(int(s) for s in shape), axis=axis, mesh=mesh)

    @property
    def rows_per_block(self) -> int:
        return int(self.cols.shape[0])

    def matvec(self, x, mesh: DeviceMesh | None = None) -> DTensor:
        return dist_ell_spmv(self, x, mesh)

    def _make_plan(self):
        r, k = self.cols.shape
        rows = torch.arange(r, device=self.cols.device)[:, None].expand(r, k)
        rows = torch.where(self.vals != 0, rows, r)
        return _rowgroup.build(rows.reshape(-1), self.cols.reshape(-1), self.vals.reshape(-1),
                               (r, self.padded_rows))


def _host_csr(csr):
    """(indptr, indices, data) of a CSR on the host, indices as int64."""
    return (csr.host("indptr").astype(np.int64), csr.host("indices").astype(np.int64),
            csr.host("data"))


def partition_csr(csr, n_blocks: int, format: str = "csr") -> dict:
    """The host partition into block rows: {"indptr", "indices", "data",
    "local_rows"} (format 'csr') or {"cols", "vals"} (format 'ell'), each
    with a leading block axis."""
    n_rows = csr.shape[0]
    r = _pad_rows(n_rows, n_blocks) // n_blocks
    indptr, indices, data = _host_csr(csr)
    counts = np.diff(indptr)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)

    if format == "ell":
        k = max(int(counts.max(initial=0)), 1)
        cols_b = np.zeros((n_blocks * r, k), np.int32)
        vals_b = np.zeros((n_blocks * r, k), data.dtype)
        pos = np.arange(nnz, dtype=np.int64) - indptr[rows]
        cols_b[rows, pos] = indices[:nnz]
        vals_b[rows, pos] = data[:nnz]
        return {"cols": cols_b.reshape(n_blocks, r, k), "vals": vals_b.reshape(n_blocks, r, k)}
    if format != "csr":
        raise ValueError(f"unknown format {format!r}; expected 'csr' or 'ell'")

    lo = np.minimum(np.arange(n_blocks) * r, n_rows)
    hi = np.minimum(lo + r, n_rows)
    start, end = indptr[lo], indptr[hi]
    nnz_max = max(int((end - start).max()), 1)
    indptr_b = np.zeros((n_blocks, r + 1), np.int32)
    indices_b = np.zeros((n_blocks, nnz_max), np.int32)
    data_b = np.zeros((n_blocks, nnz_max), data.dtype)
    lrows_b = np.full((n_blocks, nnz_max), r, np.int32)
    for b in range(n_blocks):
        s, e = start[b], end[b]
        indices_b[b, : e - s] = indices[s:e]
        data_b[b, : e - s] = data[s:e]
        local_ptr = indptr[lo[b]: hi[b] + 1] - s
        indptr_b[b, : hi[b] - lo[b] + 1] = local_ptr
        indptr_b[b, hi[b] - lo[b] + 1:] = local_ptr[-1]
        lrows_b[b, : e - s] = rows[s:e] - lo[b]
    return {"indptr": indptr_b, "indices": indices_b, "data": data_b, "local_rows": lrows_b}


def distribute_csr(csr, mesh: DeviceMesh, axis: str = ROWS_AXIS, format: str = "csr"):
    """Partition a CSR matrix into block rows over the mesh; ``format='ell'``
    gives DistELL blocks.  This rank keeps its block."""
    parts = partition_csr(csr, _n_blocks(mesh, axis), format)
    cls = DistELL if format == "ell" else DistCSR
    return cls.from_global(parts, shape=csr.shape, mesh=mesh, axis=axis)


def _all_of_x(mat, x) -> torch.Tensor:
    """The whole padded x on this rank (all-gathered)."""
    xl = _local(mat, x)
    return _all_gather(mat.mesh, xl) if mat.n_blocks > 1 else xl


def dist_csr_spmv(mat: DistCSR, x, mesh: DeviceMesh | None = None) -> DTensor:
    """y = A @ x with an all-gathered operand (general column structure)."""
    mat._check_mesh(mesh)
    return _sharded(mat, _plan_spmv(mat.shard_plan(), _all_of_x(mat, x), "dist_csr_spmv"))


def dist_ell_spmv(mat: DistELL, x, mesh: DeviceMesh | None = None) -> DTensor:
    """y = A @ x with an all-gathered operand, over ELL blocks."""
    mat._check_mesh(mesh)
    return _sharded(mat, _plan_spmv(mat.shard_plan(), _all_of_x(mat, x), "dist_ell_spmv"))


# --- DistCSRSubset: the per-hop subset exchange -------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DistCSRSubset(_RowPartitioned):
    """General sparse matrix, block-row partitioned, exchanging only the
    entries of x that each peer's rows read.  ``send_idx[k]``: (hop_m[k],)
    the local x indices this rank ships on hop k + 1, to the rank k + 1
    ahead (pad 0; never read); ``indices``: (nnz_max,) local renumbered
    columns, [0, rpb) its own block and rpb + (slots of the hops before) +
    pos the pos-th entry received on a hop; ``data``, ``local_rows`` as in
    DistCSR."""

    send_idx: Tuple[torch.Tensor, ...]
    indices: torch.Tensor
    data: torch.Tensor
    local_rows: torch.Tensor
    shape: Tuple[int, int]
    axis: str
    mesh: DeviceMesh
    hop_m: Tuple[int, ...]
    rpb: int

    @classmethod
    def from_global(cls, fields: dict, *, shape, mesh: DeviceMesh,
                    axis: str = ROWS_AXIS) -> "DistCSRSubset":
        """This rank's part of the global arrays (``send_idx``: one (n_blocks,
        hop_m[k]) array a hop) and the static ``hop_m`` and ``rpb``."""
        _n_blocks(mesh, axis)
        sends = fields["send_idx"]
        return cls(send_idx=tuple(_rank_part({"send_idx": s}, "send_idx", mesh) for s in sends),
                   **{f: _rank_part(fields, f, mesh) for f in ("indices", "data", "local_rows")},
                   shape=tuple(int(s) for s in shape), axis=axis, mesh=mesh,
                   hop_m=tuple(int(m) for m in fields["hop_m"]), rpb=int(fields["rpb"]))

    @property
    def rows_per_block(self) -> int:
        return self.rpb

    def exchange_bytes_per_spmv(self) -> int:
        """Interconnect payload per SpMV: Σ over hops of n_blocks · hop_m
        values (each hop padded to its own largest subset)."""
        return self.n_blocks * sum(self.hop_m) * self.data.element_size()

    def matvec(self, x, mesh: DeviceMesh | None = None) -> DTensor:
        return dist_csr_subset_spmv(self, x, mesh)

    def _make_plan(self):
        return _rowgroup.build(self.local_rows, self.indices, self.data,
                               (self.rpb, self.rpb + sum(self.hop_m)))


_EMPTY_I64 = np.zeros(0, np.int64)


def partition_csr_subset(csr, n_blocks: int) -> dict:
    """The host partition with the needed-column subsets: {"send_idx"
    (one (n_blocks, hop_m[k]) array a hop), "indices", "data",
    "local_rows", "hop_m", "rpb"}.  Needs n_cols ≤ the padded rows."""
    n_dev = n_blocks
    n_rows, n_cols = csr.shape
    r = _pad_rows(max(n_rows, n_cols), n_dev) // n_dev
    indptr, indices, data = _host_csr(csr)

    needed = {}          # (owner d, consumer b) -> sorted unique local cols
    block_entries = []
    for b in range(n_dev):
        lo, hi = min(b * r, n_rows), min((b + 1) * r, n_rows)
        s, e = indptr[lo], indptr[hi]
        cols_b = indices[s:e]
        owners = cols_b // r
        for d in np.unique(owners):
            if d != b:
                needed[(int(d), b)] = np.unique(cols_b[owners == d] - d * r)
        block_entries.append((lo, hi, s, e, cols_b, owners))

    # hop k carries owner d → consumer (d + k) % n_dev, padded to the hop's max
    hop_m = []
    send_idx = []
    for k in range(1, n_dev):
        mk = max([needed.get((d, (d + k) % n_dev), _EMPTY_I64).size
                  for d in range(n_dev)] + [1])
        sk = np.zeros((n_dev, mk), np.int32)
        for d in range(n_dev):
            v = needed.get((d, (d + k) % n_dev))
            if v is not None:
                sk[d, : v.size] = v
        hop_m.append(mk)
        send_idx.append(sk)
    hop_off = np.concatenate([[0], np.cumsum(hop_m)]).astype(np.int64)

    nnz_max = max(max((e - s) for (_, _, s, e, _, _) in block_entries), 1)
    indices_b = np.zeros((n_dev, nnz_max), np.int32)
    data_b = np.zeros((n_dev, nnz_max), data.dtype)
    lrows_b = np.full((n_dev, nnz_max), r, np.int32)
    for b, (lo, hi, s, e, cols_b, owners) in enumerate(block_entries):
        local = np.empty(cols_b.shape, np.int64)
        own = owners == b
        local[own] = cols_b[own] - b * r
        for d in np.unique(owners):
            if d == b:
                continue
            k = (b - d) % n_dev          # the hop that brings owner d's entries to b
            sel = owners == d
            pos = np.searchsorted(needed[(int(d), b)], cols_b[sel] - d * r)
            local[sel] = r + hop_off[k - 1] + pos
        indices_b[b, : e - s] = local
        data_b[b, : e - s] = data[s:e]
        lrows_b[b, : e - s] = np.repeat(
            np.arange(hi - lo, dtype=np.int32), np.diff(indptr[lo:hi + 1]))
    return {"send_idx": tuple(send_idx), "indices": indices_b, "data": data_b,
            "local_rows": lrows_b, "hop_m": tuple(hop_m), "rpb": r}


def distribute_csr_subset(csr, mesh: DeviceMesh, axis: str = ROWS_AXIS) -> DistCSRSubset:
    """Partition a CSR matrix with its needed-column subsets computed once
    on the host; this rank keeps its block."""
    return DistCSRSubset.from_global(partition_csr_subset(csr, _n_blocks(mesh, axis)),
                                     shape=csr.shape, mesh=mesh, axis=axis)


def dist_csr_subset_spmv(mat: DistCSRSubset, x, mesh: DeviceMesh | None = None) -> DTensor:
    """y = A @ x with the subset exchange: on hop k, the entries the rank k
    ahead reads go to it; then the shard product over [own x | hop 1 |
    ...]."""
    mat._check_mesh(mesh)
    xl = _local(mat, x)
    parts = [xl]
    if mat.n_blocks > 1:
        parts += _shift(mat.mesh, [(xl[s.long()], k) for k, s in enumerate(mat.send_idx, 1)])
    x_loc = torch.cat(parts) if len(parts) > 1 else xl
    return _sharded(mat, _plan_spmv(mat.shard_plan(), x_loc, "dist_csr_subset_spmv"))


# --- DistSlab ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DistSlab(_RowPartitioned):
    """Scattered bounded-span matrix (SlabELL), block-row partitioned.
    This rank's ``vals`` / ``lidx`` (blocks_per_rank, C, rb) of one global
    SlabELL freeze and ``win_lo`` (blocks_per_rank,), shifted into the
    windows of the local extended x ([halo | own | halo]).  ``shard``: the
    local SlabELL (shape (r, r + 2·halo_windows·128), no counts), made
    once."""

    vals: torch.Tensor
    lidx: torch.Tensor
    win_lo: torch.Tensor
    shape: Tuple[int, int]
    buckets: Tuple[Tuple[int, int], ...]
    halo_windows: int
    local_windows: int
    axis: str
    mesh: DeviceMesh

    def __post_init__(self):
        r = self.rows_per_block
        object.__setattr__(self, "shard", SlabELL(
            vals=self.vals, lidx=self.lidx, win_lo=self.win_lo, bucket_cnt=None,
            shape=(r, r + 2 * self.halo_windows * WINDOW), buckets=self.buckets))

    @classmethod
    def from_global(cls, fields: dict, *, shape, mesh: DeviceMesh,
                    axis: str = ROWS_AXIS) -> "DistSlab":
        """This rank's part of the global arrays (``vals``/``lidx`` (n_blocks,
        blocks_per_rank, C, rb), ``win_lo`` (n_blocks, blocks_per_rank)) and
        the static ``buckets``, ``halo_windows`` and ``local_windows``."""
        _n_blocks(mesh, axis)
        return cls(**{f: _rank_part(fields, f, mesh) for f in ("vals", "lidx", "win_lo")},
                   shape=tuple(int(s) for s in shape),
                   buckets=tuple((int(o), int(h)) for o, h in fields["buckets"]),
                   halo_windows=int(fields["halo_windows"]),
                   local_windows=int(fields["local_windows"]), axis=axis, mesh=mesh)

    @property
    def rows_per_block(self) -> int:
        return self.local_windows * WINDOW

    def matvec(self, x, mesh: DeviceMesh | None = None) -> DTensor:
        return dist_slab_spmv(self, x, mesh)

    def _make_plan(self):
        if self.vals.device.type == "cpu":
            return None
        return _rowgroup.plan_of(self.shard)


def partition_slab(csr, n_blocks: int, rb: int | None = None) -> dict:
    """The host partition into window-bucketed slabs: one global SlabELL
    freeze (on the host) regrouped into per-rank block runs: {"vals",
    "lidx", "win_lo", "buckets", "halo_windows", "local_windows"}."""
    rb = rb or SLAB_ROW_BLOCK
    n_dev = n_blocks
    n_rows = csr.shape[0]
    # rows a rank: a multiple of the row block (rb is a 128-multiple)
    r = -(-(-(-n_rows // n_dev)) // rb) * rb
    host = CSR.from_arrays(*(csr.host(f) for f in ("indptr", "indices", "data")), csr.shape,
                           device="cpu")
    sl = SlabELL.from_csr(host, rb=rb)
    nrb_total = n_dev * (r // rb)
    pad_blocks = nrb_total - sl.n_row_blocks
    vals, lidx = sl.host("vals"), sl.host("lidx")
    wlo = sl.host("win_lo").astype(np.int64)
    if pad_blocks:
        vals = np.concatenate([vals, np.zeros((pad_blocks,) + vals.shape[1:], vals.dtype)])
        lidx = np.concatenate([lidx, np.zeros((pad_blocks,) + lidx.shape[1:], lidx.dtype)])
        wlo = np.concatenate([wlo, np.zeros(pad_blocks, wlo.dtype)])
    nrb_l = r // rb
    w_l = r // WINDOW
    s = sl.slab_windows
    dev = np.arange(nrb_total) // nrb_l
    # halo: how far any block's slab reaches outside its rank's x block
    h = int(max(0, (dev * w_l - wlo).max(initial=0),
                (wlo + s - (dev + 1) * w_l).max(initial=0)))
    wlo_local = wlo - dev * w_l + h
    return {"vals": vals.reshape((n_dev, nrb_l) + vals.shape[1:]),
            "lidx": lidx.reshape((n_dev, nrb_l) + lidx.shape[1:]),
            "win_lo": wlo_local.reshape(n_dev, nrb_l).astype(np.int32),
            "buckets": sl.buckets, "halo_windows": h, "local_windows": w_l}


def distribute_slab(csr, mesh: DeviceMesh, axis: str = ROWS_AXIS,
                    rb: int | None = None) -> DistSlab:
    """Partition a matrix over the mesh as window-bucketed slabs; this
    rank keeps its run of row blocks."""
    return DistSlab.from_global(partition_slab(csr, _n_blocks(mesh, axis), rb),
                                shape=csr.shape, mesh=mesh, axis=axis)


def dist_slab_spmv(mat: DistSlab, x, mesh: DeviceMesh | None = None) -> DTensor:
    """y = A @ x with the window-halo exchange.  ``x``: the padded sharded
    vector; returns the padded sharded result.  The wrapped halo at the
    first and last rank meets only padding slots (value 0)."""
    mat._check_mesh(mesh)
    h, w_l = mat.halo_windows, mat.local_windows
    if h > w_l:
        raise ValueError(
            f"halo ({h} windows) exceeds the local shard ({w_l} windows) — "
            f"use DistELL (all-gather) for this span/mesh combination")
    xl = _local(mat, x)
    r, hx = mat.rows_per_block, h * WINDOW
    if h > 0 and mat.n_blocks > 1:
        left, right = _shift(mat.mesh, [(xl[r - hx:], 1), (xl[:hx], -1)])
        x_ext = torch.cat([left, xl, right])
    elif h > 0:
        x_ext = F.pad(xl, (hx, hx))
    else:
        x_ext = xl
    return _sharded(mat, planned_spmv(mat.shard, x_ext, LAUNCHES, "dist_slab_spmv"))
