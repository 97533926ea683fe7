"""Dtype and index-width policy for the PyTorch port.

Counterpart of ``sparsemat_tpu/types.py``: the index and value dtypes a
matrix may hold and their checks, the default index width, the compute
width of a narrow index, the UNSET padding sentinel and the accumulation
rule, in torch dtypes.  Host-side freezes run in numpy, so each torch dtype also has the
numpy dtype its host arrays use (bfloat16 has none and stages in float32).

Also the device policy: an entry point that builds tensors (a freeze from
host arrays, a loader, ``to_torch``) puts them on ``default_device()``, the
current CUDA card, unless the caller names a device; ``device="cpu"`` asks
for the CPU.  Formats derived from a matrix stay on that matrix's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

#: Index dtypes accepted for sparse structure arrays.
INDEX_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)

#: Default index dtype.
DEFAULT_INDEX_DTYPE = torch.int32

#: Value dtypes a matrix may hold.
VALUE_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16,
                torch.int8, torch.int16, torch.int32, torch.int64)

#: Float dtypes allowed in iterative solvers (the FloatType gate).
FLOAT_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)

_NP_OF = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.float16: np.float16, torch.bfloat16: np.float32,
    torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
    torch.int64: np.int64, torch.bool: np.bool_,
}
_TORCH_OF = {np.dtype(v): k for k, v in _NP_OF.items() if k != torch.bfloat16}


def as_torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype == "bfloat16":
        return torch.bfloat16
    return _TORCH_OF[np.dtype(dtype)]


def host_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype that host-side (freeze) arrays of ``dtype`` use."""
    return np.dtype(_NP_OF[as_torch_dtype(dtype)])


def unset_value(index_dtype: Any) -> int:
    """UNSET sentinel for an index dtype = its max value."""
    return int(torch.iinfo(as_torch_dtype(index_dtype)).max)


def _checked(dtype: Any, allowed, what: str) -> torch.dtype:
    try:
        dt = as_torch_dtype(dtype)
    except (KeyError, TypeError):
        dt = None
    if dt not in allowed:
        raise TypeError(f"unsupported {what} dtype {dtype!r}; expected one of {allowed}")
    return dt


def check_index_dtype(index_dtype: Any) -> torch.dtype:
    """``index_dtype`` as a torch dtype; a ``TypeError`` that names it
    unless it is one of ``INDEX_DTYPES``."""
    return _checked(index_dtype, INDEX_DTYPES, "index")


def check_value_dtype(dtype: Any) -> torch.dtype:
    """``dtype`` as a torch dtype; a ``TypeError`` that names it unless it
    is one of ``VALUE_DTYPES``."""
    return _checked(dtype, VALUE_DTYPES, "value")


def is_float_dtype(dtype: Any) -> bool:
    return as_torch_dtype(dtype) in FLOAT_DTYPES


def compute_index_dtype(index_dtype: Any) -> torch.dtype:
    """A storage index dtype widened to the compute width (int32 at least)."""
    dt = as_torch_dtype(index_dtype)
    return torch.int32 if dt.itemsize < 4 else dt


def default_device() -> torch.device:
    """The current CUDA device.  Raises where torch finds no CUDA card: the
    port never falls back to the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("sparsemat_tpu_torch: torch finds no CUDA card; pass "
                           "device='cpu' to build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device, None read as ``default_device()``."""
    return default_device() if device is None else torch.device(device)


def accum_dtype(dtype: Any) -> torch.dtype:
    """Accumulation dtype for reductions: bf16/f16 accumulate in f32;
    every other dtype (f64 included) accumulates in itself."""
    dt = as_torch_dtype(dtype)
    if dt in (torch.bfloat16, torch.float16):
        return torch.float32
    return dt


@dataclasses.dataclass(frozen=True)
class TypePolicy:
    """A (value dtype, index storage dtype) pair, both checked."""

    dtype: Any = torch.float32
    index_dtype: Any = DEFAULT_INDEX_DTYPE

    def __post_init__(self):
        object.__setattr__(self, "dtype", check_value_dtype(self.dtype))
        object.__setattr__(self, "index_dtype", check_index_dtype(self.index_dtype))

    @property
    def unset(self) -> int:
        return unset_value(self.index_dtype)


DEFAULT_POLICY = TypePolicy()
