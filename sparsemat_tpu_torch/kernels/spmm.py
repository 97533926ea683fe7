"""BSR SpMM: the CUDA kernel's wrapper, its plain version and launch counter
(counterpart of the BSR half of ``sparsemat_tpu/kernels/spmm.py``; the slab
SpMM is in ``kernels/slab.py``).

Y = A @ B with A a BSR and B dense (n_cols, m).  The CUDA kernel lives in
``csrc/bsr.cu`` (see the note there for what it replaces and what bounds
it): each output sub-block is summed in registers over its block row's
tiles and written once, so the TPU's first-visit zeroing, its column
tiling of B and its chunked calls have no counterpart.  The plain version
is the JAX package's ``bsr_spmm_xla``: a batched product of every block
with its slice of B, then a segment sum over each block row's tiles.

Dtypes: the blocks and B are cast to the accumulation dtype of the two
(bf16/f16 to f32) before the launch, as the JAX wrapper casts them; the
kernel runs in f32 or f64, with plain FMAs (no TF32), as the TPU kernel
runs at ``Precision.HIGHEST``.  The wrapper takes the plain version only
when its tensors lie on the CPU; on a CUDA tensor it launches the kernel
or raises.  The tile order is checked once per matrix and the launch plan
(the per-block-row tile pointer) cached on it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.bsr import BSR
from ..types import FLOAT_DTYPES, accum_dtype
from .._build import load_cuda

#: kernel launches (plain versions do not count)
LAUNCHES = {"bsr_spmm": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/bsr.cu`` library."""
    global _lib
    if _lib is None:
        lib = load_cuda("bsr")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_bsr_spmm_{s}")
            fn.argtypes = [vp, vp, vp, i32, i32, i32, i64, i64, i64, vp, vp, vp]
            fn.restype = i32
        lib.smt_bsr_error_string.argtypes = [i32]
        lib.smt_bsr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _adt(bsr: BSR, B: torch.Tensor) -> torch.dtype:
    return accum_dtype(torch.promote_types(bsr.blocks.dtype, B.dtype))


# --- plain version -------------------------------------------------------------

def bsr_spmm_ref(bsr: BSR, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B: each block times the ``bc`` rows of B at its block column
    (rows past n_cols and block columns past the end read 0), a batched
    product in the accumulation dtype, then each block row's tiles summed
    in tile order (a segment sum over the stably sorted block rows, no
    atomics).  On a card the product runs in full f32 when TF32 is off
    (``torch.backends.cuda.matmul.allow_tf32``, False by default)."""
    n_rows, _ = bsr.shape
    t, br, bc = bsr.blocks.shape
    m = B.shape[1]
    adt = _adt(bsr, B)
    if m == 0 or t == 0:
        return torch.zeros((n_rows, m), dtype=adt, device=B.device)
    n_rb = -(-n_rows // br)
    Bp = F.pad(B.to(adt), (0, 0, 0, -B.shape[0] % bc))
    kb = Bp.shape[0] // bc
    Bb = Bp.reshape(kb, bc, m)
    bcols = bsr.block_cols.long()
    inside = (bcols >= 0) & (bcols < kb)
    gathered = Bb[torch.where(inside, bcols, 0)] if kb else Bb.new_zeros((t, bc, m))
    gathered = torch.where(inside[:, None, None], gathered, 0)
    partial = torch.bmm(bsr.blocks.to(adt), gathered)                    # (T, br, m)
    brows = bsr.block_rows.long()
    keep = (brows >= 0) & (brows < n_rb)
    order = torch.sort(torch.where(keep, brows, n_rb), stable=True).indices
    counts = torch.bincount(brows[keep], minlength=n_rb)
    Y = torch.segment_reduce(partial[order[: int(counts.sum())]], "sum",
                             lengths=counts, axis=0, unsafe=True)
    return Y.reshape(-1, m)[:n_rows]


# --- the kernel ----------------------------------------------------------------

def bsr_spmm_flops(bsr: BSR, m: int) -> int:
    """Flops over the stored blocks (2·T·br·bc·m): what the kernel does."""
    return 2 * bsr.blocks.numel() * int(m)


class _Plan:
    """What one launch needs besides B, built once per matrix after the
    tile order is checked: the per-block-row tile pointer (block_rows
    ascending, within the matrix; block columns not negative)."""

    def __init__(self, bsr: BSR):
        if bsr.blocks.device.type != "cuda" or any(
                t.device != bsr.blocks.device for t in (bsr.block_rows, bsr.block_cols)):
            raise ValueError(f"bsr_spmm: the kernel needs blocks, block_rows and "
                             f"block_cols on one CUDA device, got {bsr.blocks.device}")
        if bsr.blocks.dtype not in FLOAT_DTYPES:
            raise TypeError(f"bsr_spmm: the CUDA kernel takes float blocks, got "
                            f"{bsr.blocks.dtype}")
        t, br, bc = bsr.blocks.shape
        rows = bsr.host("block_rows").astype(np.int64)
        cols = bsr.host("block_cols").astype(np.int64)
        n_rb = -(-bsr.shape[0] // br)
        if rows.shape != (t,) or cols.shape != (t,):
            raise ValueError("bsr_spmm: block_rows / block_cols do not match the blocks")
        if t and (np.any(np.diff(rows) < 0) or rows[0] < 0 or rows[-1] >= n_rb
                  or cols.min() < 0):
            raise ValueError("bsr_spmm: the kernel needs block_rows ascending within "
                             "the matrix and block_cols >= 0")
        self.tile_ptr = torch.from_numpy(np.searchsorted(
            rows, np.arange(n_rb + 1)).astype(np.int32)).to(bsr.blocks.device)
        self.block_cols = bsr.block_cols.to(torch.int32).contiguous()
        self.n_rb = n_rb


def _plan(bsr: BSR) -> _Plan:
    """The matrix's launch plan, cached on it (a frozen matrix's layout and
    values never change)."""
    plan = bsr.__dict__.get("_bsr_plan")
    if plan is None:
        plan = _Plan(bsr)
        object.__setattr__(bsr, "_bsr_plan", plan)
    return plan


def bsr_spmm(bsr: BSR, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B.  CUDA: one launch of ``bsr_spmm_kernel``; CPU: the plain
    version."""
    n_rows, n_cols = bsr.shape
    if B.dim() != 2 or B.shape[0] != n_cols:
        raise ValueError(f"bsr_spmm: B of shape {tuple(B.shape)} for a {bsr.shape} matrix")
    m = B.shape[1]
    if bsr.blocks.device.type == "cpu" and B.device.type == "cpu":
        return bsr_spmm_ref(bsr, B)
    if B.device != bsr.blocks.device:
        raise ValueError(f"bsr_spmm: matrix on {bsr.blocks.device} and B on {B.device}; "
                         f"the kernel needs both on one CUDA device")
    if B.dtype not in FLOAT_DTYPES:
        raise TypeError(f"bsr_spmm: the CUDA kernel takes a float B, got {B.dtype}")
    plan = _plan(bsr)
    adt = _adt(bsr, B)
    if m == 0 or bsr.n_tiles == 0:
        return torch.zeros((n_rows, m), dtype=adt, device=B.device)
    blocks = bsr.blocks.to(adt).contiguous()
    Bc = B.to(adt).contiguous()
    Y = torch.empty((n_rows, m), dtype=adt, device=B.device)
    lib = _kernels()
    with torch.cuda.device(B.device):
        rc = getattr(lib, f"smt_bsr_spmm_{_SUFFIX[adt]}")(
            blocks.data_ptr(), plan.block_cols.data_ptr(), plan.tile_ptr.data_ptr(),
            plan.n_rb, bsr.br, bsr.bc, n_rows, n_cols, m,
            Bc.data_ptr(), Y.data_ptr(), torch.cuda.current_stream(B.device).cuda_stream)
    if rc != 0:
        msg = lib.smt_bsr_error_string(rc).decode()
        raise RuntimeError(f"bsr_spmm: CUDA error {rc} ({msg})")
    LAUNCHES["bsr_spmm"] += 1
    return Y


def spmm_pallas(mat, B: torch.Tensor) -> torch.Tensor:
    """Dispatch entry for ``ops.spmm(method='pallas')`` (the JAX package's
    name): a BSR as it is, any other format frozen to BSR first."""
    bsr = mat if isinstance(mat, BSR) else BSR.from_csr(mat.to_csr())
    return bsr_spmm(bsr, B)
