"""DIA SpMV kernels: wrappers, plain versions and launch counters.

The CUDA kernels live in ``csrc/dia.cu`` (see the note there for what they
replace and what bounds them).  Each wrapper takes its plain PyTorch version
only when its tensors lie on the CPU; on a CUDA tensor it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches, one per launch, so
a run can show that its main path went through the kernels.

Dtypes: every combination the JAX package's ``spmv`` takes on a DIA runs
through a kernel.  Operands of two dtypes are promoted as
``torch.promote_types`` does; bf16 and f16 are read as they are stored and
accumulated in f32 (``types.accum_dtype``), so y is f32.  The chain carries
the accumulation dtype through its steps (f32 or f64).

The TPU kernels' chunk plan (``_plan``, ``VMEM_BUDGET``, ``ALIGN``, lane
rolls) sized buffers for the TPU's on-chip memory; nothing of it applies
here.
"""

from __future__ import annotations

import ctypes

import torch

from ..formats.dia import DIA
from ..formats.dia import dia_spmv as dia_spmv_ref
from ..types import FLOAT_DTYPES, accum_dtype
from .._build import load_cuda

#: kernel launches per wrapper (plain versions do not count)
LAUNCHES = {"dia_spmv": 0, "dia_spmv_dot": 0, "dia_spmv_chain": 0}

#: grid cap of the SpMV kernels; past it each thread loops over rows
MAX_BLOCKS = 1 << 16

#: SpMV kernel per storage dtype (y and the dot in accum_dtype of it)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16", torch.float16: "f16"}
#: the chain runs in the accumulation dtype
_CHAIN_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None
_chain_max_blocks: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/dia.cu`` library."""
    global _lib
    if _lib is None:
        lib = load_cuda("dia")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_dia_spmv_{s}")
            fn.argtypes = [vp, vp, i32, i64, i64, vp, vp, vp, i32, vp]
            fn.restype = i32
        for s in _CHAIN_SUFFIX.values():
            fn = getattr(lib, f"smt_dia_chain_{s}")
            fn.argtypes = [vp, vp, i32, i64, vp, vp, vp, i32, i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"smt_dia_chain_max_blocks_{s}")
            fn.argtypes = [ctypes.POINTER(i32)]
            fn.restype = i32
        lib.smt_dia_threads.restype = i32
        lib.smt_cuda_error_string.argtypes = [i32]
        lib.smt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernels().smt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _on_cpu(dia: DIA, x: torch.Tensor) -> bool:
    return dia.data.device.type == "cpu" and x.device.type == "cpu"


def _operands(dia: DIA, x: torch.Tensor, what: str, dtype=None):
    """(data, x) for the CUDA kernel: both on one CUDA device, contiguous, of
    one dtype — ``dtype``, or else ``torch.promote_types`` of the two.
    Raises on anything the kernels do not take."""
    if x.device.type != "cuda" or dia.data.device != x.device:
        raise ValueError(f"{what}: matrix on {dia.data.device} and vector on "
                         f"{x.device}; the kernel needs both on one CUDA device")
    if dia.data.dtype not in FLOAT_DTYPES or x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"{what}: the CUDA kernels take float32, float64, "
                        f"bfloat16 or float16 operands, got {dia.data.dtype} "
                        f"and {x.dtype}")
    n_rows, n_cols = dia.shape
    if tuple(dia.data.shape) != (len(dia.offsets), n_rows):
        raise ValueError(f"{what}: data has shape {tuple(dia.data.shape)}, "
                         f"expected {(len(dia.offsets), n_rows)}")
    if x.dim() != 1 or x.shape[0] != n_cols:
        raise ValueError(f"{what}: vector of shape {tuple(x.shape)} for a "
                         f"{dia.shape} matrix")
    if not (dia.data.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{what}: the kernel needs contiguous data and x")
    if dtype is None:
        dtype = torch.promote_types(dia.data.dtype, x.dtype)
    return dia.data.to(dtype), x.to(dtype)


def _require_square(dia: DIA, what: str) -> None:
    if dia.shape[0] != dia.shape[1]:
        raise ValueError(f"{what} needs a square matrix, got {dia.shape}")


def _spmv_blocks(n_rows: int, threads: int) -> int:
    return max(1, min(-(-n_rows // threads), MAX_BLOCKS))


def _launch_spmv(dia: DIA, x: torch.Tensor, with_dot: bool, what: str):
    data, x = _operands(dia, x, what)
    lib = _kernels()
    n_rows, n_cols = dia.shape
    adt = accum_dtype(data.dtype)
    blocks = _spmv_blocks(n_rows, lib.smt_dia_threads())
    y = torch.empty(n_rows, dtype=adt, device=x.device)
    partials = (torch.empty(blocks, dtype=adt, device=x.device)
                if with_dot else None)
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"smt_dia_spmv_{_SUFFIX[data.dtype]}")(
            data.data_ptr(), dia.offsets_dev.data_ptr(), len(dia.offsets),
            n_rows, n_cols, x.data_ptr(), y.data_ptr(),
            partials.data_ptr() if with_dot else None, blocks,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, what)
    return y, partials


# --- plain versions ----------------------------------------------------------

def dia_spmv_dot_ref(dia: DIA, x: torch.Tensor):
    """(A @ x, x·(A @ x)) — the plain version of the fused dot kernel."""
    y = dia_spmv_ref(dia, x)
    return y, torch.sum(x.to(y.dtype) * y)


def dia_spmv_chain_ref(dia: DIA, x: torch.Tensor, k: int) -> torch.Tensor:
    """x ← Aᵏ x by k plain SpMVs, in the accumulation dtype throughout."""
    x = x.to(accum_dtype(torch.promote_types(dia.data.dtype, x.dtype)))
    for _ in range(int(k)):
        x = dia_spmv_ref(dia, x)
    return x


# --- wrappers ----------------------------------------------------------------

def dia_spmv(dia: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  CUDA: the ``dia_spmv_kernel``; CPU: the plain version."""
    if _on_cpu(dia, x):
        return dia_spmv_ref(dia, x)
    y, _ = _launch_spmv(dia, x, with_dot=False, what="dia_spmv")
    LAUNCHES["dia_spmv"] += 1
    return y


def dia_spmv_dot(dia: DIA, x: torch.Tensor):
    """(A @ x, x·(A @ x)) in one pass over the matrix (square A) — CG's
    A·p and pᵀAp.  The dot's per-block partials are summed by torch.sum."""
    _require_square(dia, "dia_spmv_dot")
    if _on_cpu(dia, x):
        return dia_spmv_dot_ref(dia, x)
    y, partials = _launch_spmv(dia, x, with_dot=True, what="dia_spmv_dot")
    LAUNCHES["dia_spmv_dot"] += 1
    return y, torch.sum(partials)


def dia_chain_plan(dia: DIA, dtype: torch.dtype) -> int:
    """Grid of the one-launch chain kernel for this CUDA DIA run in
    ``dtype`` (f32 or f64): the co-resident blocks, or fewer for a small
    matrix.  Raises on a device without cooperative launch."""
    lib = _kernels()
    key = (dia.data.device, dtype)
    if key not in _chain_max_blocks:
        nb = ctypes.c_int(0)
        with torch.cuda.device(dia.data.device):
            rc = getattr(lib, f"smt_dia_chain_max_blocks_{_CHAIN_SUFFIX[dtype]}")(
                ctypes.byref(nb))
        _check(rc, "dia_chain_plan")
        _chain_max_blocks[key] = nb.value
    max_blocks = _chain_max_blocks[key]
    if max_blocks == 0:
        raise RuntimeError(f"dia_spmv_chain: {dia.data.device} has no "
                           f"cooperative launch, which the chain kernel needs")
    return max(1, min(max_blocks, -(-dia.shape[0] // lib.smt_dia_threads())))


def dia_spmv_chain(dia: DIA, x: torch.Tensor, k: int) -> torch.Tensor:
    """x ← Aᵏ x (square A), in the accumulation dtype of the operands.
    CUDA: one launch of ``dia_chain_kernel``; CPU: the plain version."""
    _require_square(dia, "dia_spmv_chain")
    k = int(k)
    if k < 0:
        raise ValueError(f"dia_spmv_chain: k must be >= 0, got {k}")
    if _on_cpu(dia, x):
        return dia_spmv_chain_ref(dia, x, k)
    adt = accum_dtype(torch.promote_types(dia.data.dtype, x.dtype))
    data, x = _operands(dia, x, "dia_spmv_chain", dtype=adt)
    if k == 0:
        return x.clone()
    blocks = dia_chain_plan(dia, adt)
    n = dia.shape[0]
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if k > 1 else out
    with torch.cuda.device(x.device):
        rc = getattr(_kernels(), f"smt_dia_chain_{_CHAIN_SUFFIX[adt]}")(
            data.data_ptr(), dia.offsets_dev.data_ptr(), len(dia.offsets),
            n, x.data_ptr(), out.data_ptr(), tmp.data_ptr(), k, blocks,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check(rc, "dia_spmv_chain")
    LAUNCHES["dia_spmv_chain"] += 1
    return out
