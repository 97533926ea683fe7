"""Helpers shared by the kernel wrappers: the fill-mode gather of the plain
versions."""

from __future__ import annotations

import torch


def gather(X: torch.Tensor, cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    """X's rows at ``cols``; a column ≥ n_cols reads 0 (the JAX package's
    fill-mode gather)."""
    inside = cols < n_cols
    if n_cols == 0:
        return X.new_zeros(tuple(cols.shape) + tuple(X.shape[1:]))
    g = X[torch.where(inside, cols, 0)]
    return torch.where(inside.reshape(inside.shape + (1,) * (X.dim() - 1)), g, 0)

