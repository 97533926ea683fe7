"""CG's step algebra as two CUDA kernels (``csrc/krylov.cu``; see the note
there for what they replace and what bounds them): the binding and its
scratch.

``cg_step`` runs one step of unpreconditioned CG after its SpMV-dot, in
place, on one CUDA card: ``cg_update_kernel`` (x += αp, r −= αAp, r·r, and
the commit of rr and k) and ``cg_direction_kernel`` (p = r + βp), each
under the step's ``active`` flag, which the update computes from the loop's
state on the device.  ``solvers.cg`` calls it where its ``_fused_reason``
finds no reason against; its plain version is that solver's body of
PyTorch ops and selects, which every other case runs.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_cuda
from ..utils import profiling

#: kernel launches (host enqueues: a launch captured into a CUDA graph counts
#: once, at its capture)
LAUNCHES = profiling.register("kernels.krylov", {"cg_update": 0, "cg_direction": 0})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: the dtypes the kernels take
DTYPES = tuple(_SUFFIX)
#: partial sums an SM may need: at most 32 CTAs an SM
_PER_SM = 32
_lib = None
_occupancy: dict = {}


def _kernels() -> ctypes.CDLL:
    """The built and bound ``csrc/krylov.cu`` library."""
    global _lib
    if _lib is None:
        lib = load_cuda("krylov")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        for s in _SUFFIX.values():
            fn = getattr(lib, f"smt_cg_occupancy_{s}")
            fn.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
            fn.restype = i32
            fn = getattr(lib, f"smt_cg_update_{s}")
            fn.argtypes = [vp] * 4 + [i64] + [vp] * 9 + [i32, i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"smt_cg_direction_{s}")
            fn.argtypes = [vp, vp, i64, vp, vp, i32, i32, vp]
            fn.restype = i32
        lib.smt_krylov_threads.restype = i32
        lib.smt_krylov_error_string.argtypes = [i32]
        lib.smt_krylov_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _kernels().smt_krylov_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _grids(device: torch.device, dtype: torch.dtype, vec: int, n: int) -> tuple[int, int]:
    """(update, direction) CTAs: the SMs times the CTAs an SM holds of
    each, at most the 16-byte vectors over a CTA's threads."""
    key = (device, dtype, vec)
    if key not in _occupancy:
        upd, dirn = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = getattr(_kernels(), f"smt_cg_occupancy_{_SUFFIX[dtype]}")(
                vec, ctypes.byref(upd), ctypes.byref(dirn))
        _check(rc, "cg_step")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _occupancy[key] = sms, min(upd.value, _PER_SM), min(dirn.value, _PER_SM)
    sms, upd, dirn = _occupancy[key]
    tiles = max(1, -(-n // (vec * _kernels().smt_krylov_threads())))
    return max(1, min(sms * upd, tiles)), max(1, min(sms * dirn, tiles))


def step_scratch(device: torch.device):
    """(work, counter) of a solve's steps: ``work`` (f64) holds room for
    every CTA's partial sum of r·r, then β and the active flag; ``counter``
    is an unsigned 0 that each update leaves at 0.  The steps of one solve
    run in order on one stream, so one pair serves them all: ``solvers.cg``
    makes it once a solve and keeps it among the loop's invariants, so a
    block graph captures the pair of its own static buffers and replays no
    fill."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return (torch.empty(_PER_SM * sms + 2, dtype=torch.float64, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def cg_step(x, r, p, Ap, pAp, rr, k, maxiter, thresh2, work, counter) -> None:
    """One step of unpreconditioned CG, committed in place where
    ``k < maxiter`` and ``rr >= thresh2`` held before it (the loop's cond):
    x += αp, r −= αAp with α = rr / pAp (0 where pAp = 0), rr = r·r of the
    new r, k += 1, then p = r + βp with β = rr_new / rr (0 where rr = 0).
    x, r, p and Ap: contiguous vectors of one dtype (f32 or f64) on one CUDA
    card; pAp, rr, thresh2 0-d of that dtype; k, maxiter 0-d int32;
    ``work`` and ``counter`` the ``step_scratch`` of the card, which no
    other stream uses meanwhile.  Two launches, no host sync."""
    dtype, dev, n = x.dtype, x.device, x.shape[0]
    vectors, scalars = (x, r, p, Ap), (pAp, rr, thresh2)
    if dtype not in _SUFFIX or dev.type != "cuda":
        raise TypeError(f"cg_step: the kernels take float32 or float64 on a CUDA card, "
                        f"got {dtype} on {dev}")
    for t in vectors + scalars + (k, maxiter, work, counter):
        if t.device != dev:
            raise ValueError(f"cg_step: operands on {dev} and {t.device}")
    if any(v.dtype != dtype or v.shape != (n,) or not v.is_contiguous() for v in vectors):
        raise ValueError(f"cg_step: x, r, p and A·p must be contiguous ({n},) {dtype} vectors, "
                         f"got {[(tuple(v.shape), v.dtype) for v in vectors]}")
    if any(s.dtype != dtype or s.dim() != 0 for s in scalars) or \
            any(s.dtype != torch.int32 or s.dim() != 0 for s in (k, maxiter)):
        raise ValueError("cg_step: pAp, rr and thresh2 must be 0-d of the vectors' dtype, "
                         "k and maxiter 0-d int32")
    vec = 16 // dtype.itemsize if _aligned(*vectors) else 1
    grid_update, grid_direction = _grids(dev, dtype, vec, n)
    if work.dtype != torch.float64 or work.dim() != 1 or work.shape[0] < grid_update + 2 or \
            counter.dtype != torch.int32 or counter.numel() != 1:
        raise ValueError("cg_step: work and counter must be a step_scratch of the card")
    sfx, lib = _SUFFIX[dtype], _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        slots = work.shape[0] - 2
        beta, flag = work[slots].data_ptr(), work[slots + 1].data_ptr()
        rc = getattr(lib, f"smt_cg_update_{sfx}")(
            x.data_ptr(), r.data_ptr(), p.data_ptr(), Ap.data_ptr(), n, pAp.data_ptr(),
            rr.data_ptr(), k.data_ptr(), maxiter.data_ptr(), thresh2.data_ptr(),
            work.data_ptr(), counter.data_ptr(), beta, flag, grid_update, vec, stream)
        _check(rc, "cg_step (update)")
        LAUNCHES["cg_update"] += 1
        rc = getattr(lib, f"smt_cg_direction_{sfx}")(
            r.data_ptr(), p.data_ptr(), n, beta, flag, grid_direction, vec, stream)
    _check(rc, "cg_step (direction)")
    LAUNCHES["cg_direction"] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
