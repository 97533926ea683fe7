"""Helpers shared by the kernel wrappers: the fill-mode gather of the plain
versions, and the per-block item ranges the SlabStream kernel walks."""

from __future__ import annotations

import numpy as np
import torch


def gather(X: torch.Tensor, cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    """X's rows at ``cols``; a column ≥ n_cols reads 0 (the JAX package's
    fill-mode gather)."""
    inside = cols < n_cols
    if n_cols == 0:
        return X.new_zeros(tuple(cols.shape) + tuple(X.shape[1:]))
    g = X[torch.where(inside, cols, 0)]
    return torch.where(inside.reshape(inside.shape + (1,) * (X.dim() - 1)), g, 0)


def block_ranges(blocks: np.ndarray, n_blocks: int):
    """(ptr, order) for a kernel that walks, per output block b, the items
    ``order[ptr[b]:ptr[b + 1]]`` (or ``ptr[b]:ptr[b + 1]`` of the storage
    order where ``order`` is None): ``blocks`` is each item's block (a
    SlabStream's blk_id).  Items already in block order
    keep it; otherwise a stable sort orders them once.  Items aimed at a
    block >= n_blocks fall past ptr[n_blocks] and are dropped."""
    blocks = np.asarray(blocks, np.int64)
    if blocks.size and blocks.min() < 0:
        raise ValueError("negative block id")
    order = None
    if np.any(np.diff(blocks) < 0):
        order = np.argsort(blocks, kind="stable")
        blocks = blocks[order]
    ptr = np.searchsorted(blocks, np.arange(n_blocks + 1)).astype(np.int64)
    return ptr, None if order is None else order[: ptr[-1]].astype(np.int64)
