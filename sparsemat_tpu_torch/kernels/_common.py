"""Helpers shared by the kernels' callers: the fill-mode gather of the plain
versions and the check of a kernel's operand."""

from __future__ import annotations

import torch

from ..types import FLOAT_DTYPES


def gather(X: torch.Tensor, cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    """X's rows at ``cols``; a column ≥ n_cols reads 0 (the JAX package's
    fill-mode gather)."""
    inside = cols < n_cols
    if n_cols == 0:
        return X.new_zeros(tuple(cols.shape) + tuple(X.shape[1:]))
    g = X[torch.where(inside, cols, 0)]
    return torch.where(inside.reshape(inside.shape + (1,) * (X.dim() - 1)), g, 0)


def check_operand(X: torch.Tensor, dev: torch.device, shape, kind: str, want: tuple) -> None:
    """Raise unless ``X`` can be a kernel's operand for a ``shape`` matrix on
    ``dev``: on that device, float, of shape ``want``."""
    if X.device != dev:
        raise ValueError(f"{kind}: matrix on {dev} and operand on {X.device}; the kernels "
                         f"need both on one CUDA device")
    if X.dtype not in FLOAT_DTYPES:
        raise TypeError(f"{kind}: the CUDA kernels take a float operand, got {X.dtype}")
    if tuple(X.shape) != want:
        raise ValueError(f"{kind}: operand of shape {tuple(X.shape)} for a {tuple(shape)} "
                         f"matrix")
