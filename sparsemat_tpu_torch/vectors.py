"""Vector types (counterpart of ``sparsemat_tpu/vectors.py``).

The compute dense vector is a plain ``torch.Tensor``.  ``DenseVec`` and
``SparseVec`` are the host-side API-parity classes: a growable dense
vector with auto-resize on write, and (indices, values) pairs in insertion
order, which ``SparseBuilder.get_row`` returns.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from .types import accum_dtype, resolve_device


# --- functional helpers (the Vector trait's default methods) -----------------

def inner_prod(a, b):
    """⟨a, b⟩, accumulated in ``accum_dtype``."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    adt = accum_dtype(a.dtype)
    return torch.dot(a.to(adt), b.to(adt))


def norm_squared(a):
    """‖a‖²."""
    return inner_prod(a, a)


def norm(a):
    """‖a‖."""
    return torch.sqrt(norm_squared(a))


# --- host-side builder vectors ----------------------------------------------

class DenseVec:
    """Growable dense vector, host-side (assembly phase only), with
    auto-resize ``set``/``add_to``.  Freeze with ``.to_torch()``."""

    def __init__(self, data=None, dtype=np.float32):
        self._data = np.array([] if data is None else data, dtype=dtype)

    @classmethod
    def from_vec(cls, values, dtype=None):
        arr = np.asarray(values)
        return cls(arr, dtype or arr.dtype)

    def _grow(self, i: int):
        if i >= self._data.shape[0]:
            pad = np.zeros(i + 1 - self._data.shape[0], self._data.dtype)
            self._data = np.concatenate([self._data, pad])

    @property
    def dim(self) -> int:
        return int(self._data.shape[0])

    def get(self, i: int):
        return self._data[i] if i < self.dim else self._data.dtype.type(0)

    def set(self, i: int, v):
        self._grow(i)
        self._data[i] = v

    def add_to(self, i: int, v):
        self._grow(i)
        self._data[i] += v

    def __getitem__(self, i):
        return self.get(i)

    def __setitem__(self, i, v):
        self.set(i, v)

    def scale(self, s):
        self._data = self._data * s
        return self

    def add(self, rhs: "DenseVec"):
        """self += rhs; raises if self is shorter."""
        if self.dim < rhs.dim:
            raise ValueError("DenseVec.add: rhs has larger dimension")
        self._data[: rhs.dim] += rhs._data
        return self

    def sub(self, rhs: "DenseVec"):
        if self.dim < rhs.dim:
            raise ValueError("DenseVec.sub: rhs has larger dimension")
        self._data[: rhs.dim] -= rhs._data
        return self

    def inner_prod(self, rhs: "DenseVec"):
        n = min(self.dim, rhs.dim)
        return float(np.dot(self._data[:n], rhs._data[:n]))

    def norm_squared(self):
        return float(np.dot(self._data, self._data))

    def norm(self):
        return float(np.sqrt(self.norm_squared()))

    def to_torch(self, device=None):
        """The values as a tensor on ``device`` (None: the current CUDA
        card)."""
        return torch.from_numpy(self._data.copy()).to(resolve_device(device))

    def to_numpy(self):
        return self._data.copy()

    def __iter__(self):
        return iter(self._data)

    def __repr__(self):
        return f"DenseVec(dim={self.dim}, dtype={self._data.dtype})"


@dataclasses.dataclass
class SparseVec:
    """Sparse vector: parallel (indices, values) in insertion order.
    Host-side.  ``to_dense()`` zero-fills through ``dim``."""

    indices: np.ndarray
    vals: np.ndarray
    dim: int

    @classmethod
    def empty(cls, dtype=np.float32, index_dtype=np.int32):
        return cls(np.array([], index_dtype), np.array([], dtype), 0)

    def _find(self, i: int):
        hits = np.nonzero(self.indices == i)[0]
        return int(hits[0]) if hits.size else None

    def get(self, i: int):
        p = self._find(i)
        return self.vals[p] if p is not None else self.vals.dtype.type(0)

    def set(self, i: int, v):
        p = self._find(i)
        if p is None:
            self.indices = np.append(self.indices, i).astype(self.indices.dtype)
            self.vals = np.append(self.vals, v).astype(self.vals.dtype)
            self.dim = max(self.dim, i + 1)
        else:
            self.vals[p] = v

    def add_to(self, i: int, v):
        p = self._find(i)
        if p is None:
            self.set(i, v)
        else:
            self.vals[p] += v

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def iter_sparse(self) -> Iterator[Tuple[int, float]]:
        """(index, value) pairs in insertion order."""
        return zip(self.indices.tolist(), self.vals.tolist())

    def sort(self):
        """In-place sort by index."""
        order = np.argsort(self.indices, kind="stable")
        self.indices = self.indices[order]
        self.vals = self.vals[order]
        return self

    def to_dense(self, dim: int | None = None) -> np.ndarray:
        out = np.zeros(dim if dim is not None else self.dim, self.vals.dtype)
        out[self.indices] = self.vals
        return out

    def to_torch(self, dim: int | None = None, device=None):
        """The dense values as a tensor on ``device`` (None: the current
        CUDA card)."""
        return torch.from_numpy(self.to_dense(dim)).to(resolve_device(device))

    def inner_prod(self, rhs) -> float:
        if isinstance(rhs, SparseVec):
            rhs = rhs.to_dense(max(self.dim, rhs.dim))
        rhs = np.asarray(rhs)
        mask = self.indices < rhs.shape[0]
        return float(np.dot(self.vals[mask], rhs[self.indices[mask]]))

    def norm_squared(self) -> float:
        return float(np.dot(self.vals, self.vals))

    def norm(self) -> float:
        return float(np.sqrt(self.norm_squared()))
