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

The chain has two kernels (``dia_chain_plan`` picks one by size): one
thread-block cluster holding the band and x in shared memory, for a band
that fits one cluster, and a cooperative grid over global memory for the
rest.  ``LAUNCHES["dia_spmv_chain"]`` counts chains; ``CHAIN_KERNELS`` says
which kernel each ran.

The TPU kernels' chunk plan (``_plan``, ``VMEM_BUDGET``, ``ALIGN``, lane
rolls) sized buffers for the TPU's on-chip memory; nothing of it applies
here.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..formats.dia import DIA
from ..formats.dia import dia_spmv as dia_spmv_ref
from ..types import FLOAT_DTYPES, accum_dtype
from .._build import load_cuda

#: kernel launches per wrapper (plain versions do not count)
LAUNCHES = {"dia_spmv": 0, "dia_spmv_dot": 0, "dia_spmv_chain": 0}
#: chain launches by kernel: the cluster kernel or the cooperative grid
CHAIN_KERNELS = {"cluster": 0, "grid": 0}

#: grid cap of the SpMV kernels; past it each thread loops over rows
MAX_BLOCKS = 1 << 16

#: SpMV kernel per storage dtype (y and the dot in accum_dtype of it)
_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16", torch.float16: "f16"}
#: the chain runs in the accumulation dtype
_CHAIN_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: cluster sizes the cluster chain launches (16 is non-portable)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: the cluster chain's size and least CTA size: the fastest of
#: chip_smoke.py phase 7's sweep on the 10^4-row band (a band that needs
#: more CTAs gets more; a longer slice more threads)
DEFAULT_CLUSTER = 16
MIN_THREADS = 256
_lib = None
_chain_max_blocks: dict = {}
_cluster_limits: dict = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, CHAIN_KERNELS):
        for name in counts:
            counts[name] = 0


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
            fn = getattr(lib, f"smt_dia_chain_cluster_{s}")
            fn.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp, vp, i32, i32,
                           i32, i32, vp]
            fn.restype = i32
            fn = getattr(lib, f"smt_dia_chain_cluster_limits_{s}")
            fn.argtypes = [ctypes.POINTER(i32), ctypes.POINTER(i32)]
            fn.restype = i32
        lib.smt_dia_chain_cluster_threads.restype = i32
        lib.smt_dia_chain_cluster_unroll.restype = i32
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


# --- the chain's plan ----------------------------------------------------------

@dataclass(frozen=True)
class ChainPlan:
    """How one chain launches, for operands of ``dtype``.  ``kernel``
    "cluster": one cluster of ``blocks`` CTAs of ``threads`` threads, each
    holding ``rows`` rows in ``smem`` bytes of shared memory; "grid": the
    cooperative grid of ``blocks`` CTAs."""
    kernel: str
    blocks: int
    dtype: torch.dtype
    rows: int = 0
    threads: int = 0
    smem: int = 0


def cluster_rows(n: int, cluster: int) -> int:
    """Rows of each CTA's slice when ``cluster`` CTAs share n rows."""
    return max(1, -(-n // cluster))


def chain_halos(offsets, n: int) -> tuple[int, int]:
    """(lo, hi): the rows below and above its own that a row's band
    reaches, at most n each."""
    lo = max([0] + [-o for o in offsets])
    hi = max([0] + list(offsets))
    return min(lo, n), min(hi, n)


def cluster_smem(n: int, n_d: int, itemsize: int, cluster: int, halo: int) -> int:
    """Shared bytes of one CTA of the cluster chain: its slice of the n_d
    diagonals, two x buffers over its rows and their ``halo`` = lo + hi
    rows, and the n_d shifts as int32."""
    rows = cluster_rows(n, cluster)
    return (n_d * rows + 2 * (rows + halo)) * itemsize + 4 * n_d


def cluster_size(n: int, n_d: int, itemsize: int, halo: int, smem_limit: int,
                 max_cluster: int, default: int = DEFAULT_CLUSTER):
    """CTAs of the cluster chain for an n-row band of n_d diagonals
    reaching ``halo`` = lo + hi rows, or None where it fits no cluster the
    card accepts (``max_cluster`` CTAs of ``smem_limit`` shared bytes
    each): ``default``, or the fewest CTAs that hold the band where it
    needs more."""
    sizes = [c for c in CLUSTER_SIZES if c <= max_cluster]
    fit = [c for c in sizes if cluster_smem(n, n_d, itemsize, c, halo) <= smem_limit]
    if not fit:
        return None
    return max(fit[0], min(default, sizes[-1]))


def push_targets(i: int, rows: int, lo: int, hi: int, n_live: int) -> list[int]:
    """The CTAs (other than row i's own) whose halo holds row i, as the
    kernel's ``push`` finds them: a halo no wider than a slice reaches
    only the next CTA on that side."""
    rank, r = divmod(i, rows)
    out = []
    if r < hi and rank > 0:
        first = rank - 1 if hi <= rows else (0 if i - hi < 0 else (i - hi) // rows)
        out += range(first, rank)
    if r >= rows - lo:
        last = min(n_live - 1, rank + 1 if lo <= rows else (i + lo) // rows)
        out += range(rank + 1, last + 1)
    return out


def cluster_limits(device: torch.device, dtype: torch.dtype):
    """The card's limits for the cluster chain in ``dtype``: (shared bytes
    a CTA may opt in to, the largest cluster the card places at that
    size), read once per device."""
    key = (torch.device(device), dtype)
    if key not in _cluster_limits:
        smem, most = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = getattr(_kernels(), f"smt_dia_chain_cluster_limits_{_CHAIN_SUFFIX[dtype]}")(
                ctypes.byref(smem), ctypes.byref(most))
        _check(rc, "dia_chain_plan")
        _cluster_limits[key] = (smem.value, most.value)
    return _cluster_limits[key]


def cluster_plan(dia: DIA, dtype: torch.dtype, cluster: int,
                 threads: int | None = None) -> ChainPlan:
    """The cluster kernel at ``cluster`` CTAs for this CUDA DIA run in
    ``dtype``, each of ``threads`` threads (at most).  By default as many
    as take the slice's rows in one pass of the kernel's unrolled rows, and
    at least ``MIN_THREADS``: fewer warps make the barrier cheaper, more
    shorten the pass.  Raises ValueError where the band does not fit that
    many CTAs' shared memory; a size the card refuses fails at the
    launch."""
    if cluster < 1 or (threads is not None and threads < 1):
        raise ValueError(f"dia_spmv_chain: a cluster of {cluster} CTAs of {threads} threads")
    lib = _kernels()
    smem_limit, _ = cluster_limits(dia.data.device, dtype)
    n, n_d = dia.shape[0], len(dia.offsets)
    smem = cluster_smem(n, n_d, dtype.itemsize, cluster, sum(chain_halos(dia.offsets, n)))
    if smem > smem_limit:
        raise ValueError(f"dia_spmv_chain: {n} rows of {n_d} diagonals need {smem} "
                         f"shared bytes a CTA at a cluster of {cluster}, more than "
                         f"the {smem_limit} a CTA may have")
    rows = cluster_rows(n, cluster)
    if threads is None:
        threads = max(MIN_THREADS, -(-rows // lib.smt_dia_chain_cluster_unroll()))
    # whole warps, no more than the rows, at most the kernel's bound
    threads = min(lib.smt_dia_chain_cluster_threads(), -(-min(threads, rows) // 32) * 32)
    return ChainPlan("cluster", cluster, dtype, rows, threads, smem)


def grid_plan(dia: DIA, dtype: torch.dtype) -> ChainPlan:
    """The cooperative grid kernel for this CUDA DIA run in ``dtype`` (f32
    or f64): the co-resident blocks, or fewer for a small matrix.  Raises
    on a device without cooperative launch."""
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
    blocks = max(1, min(max_blocks, -(-dia.shape[0] // lib.smt_dia_threads())))
    return ChainPlan("grid", blocks, dtype)


def dia_chain_plan(dia: DIA, dtype: torch.dtype) -> ChainPlan:
    """The chain's kernel for this CUDA DIA run in ``dtype`` (f32 or f64),
    by size alone: the cluster kernel where the band fits one cluster that
    the card accepts, at ``cluster_size`` CTAs; otherwise the cooperative
    grid."""
    smem_limit, max_cluster = cluster_limits(dia.data.device, dtype)
    n = dia.shape[0]
    c = cluster_size(n, len(dia.offsets), dtype.itemsize, sum(chain_halos(dia.offsets, n)),
                     smem_limit, max_cluster)
    return grid_plan(dia, dtype) if c is None else cluster_plan(dia, dtype, c)


def dia_chain_cluster_walk(dia: DIA, x: torch.Tensor, k: int, cluster: int) -> torch.Tensor:
    """x ← Aᵏ x in the cluster kernel's schedule, in plain torch.  CTA t
    owns rows [t·rows, (t+1)·rows) and keeps two buffers over rows
    [t·rows − lo, (t+1)·rows + hi), zero outside the matrix.  Each step
    sums every row's diagonals in order from its own CTA's buffer, writes
    the CTA's next buffer, and pushes each row into the next buffer of
    every other CTA whose halo holds it, by the kernel's target arithmetic
    (``push_targets``).  The walk checks that after the pushes every
    CTA's next buffer holds the whole step over its rows and halo."""
    adt = accum_dtype(torch.promote_types(dia.data.dtype, x.dtype))
    x = x.to(adt)
    if int(k) == 0:
        return x.clone()
    n = dia.shape[0]
    dev = x.device
    rows = cluster_rows(n, cluster)
    lo, hi = chain_halos(dia.offsets, n)
    ext = rows + lo + hi
    n_live = (n - 1) // rows + 1
    i = torch.arange(n, device=dev)
    rank, slot = i // rows, i % rows
    # slot q of CTA t's buffers is row t·rows − lo + q
    row_of = torch.arange(cluster, device=dev)[:, None] * rows - lo + torch.arange(ext, device=dev)
    inside = (row_of >= 0) & (row_of < n)
    live = torch.arange(cluster, device=dev) < n_live
    bufs = torch.zeros(cluster, 2, ext, dtype=adt, device=dev)
    bufs[:, 0] = torch.where(inside, x[row_of.clamp(0, max(n - 1, 0))], 0)
    # the rows each CTA receives from the others
    pushes = [[] for _ in range(cluster)]
    for row in ((slot < hi) | (slot >= rows - lo)).nonzero().flatten().tolist():
        for t in push_targets(row, rows, lo, hi, n_live):
            pushes[t].append(row)
    pushes = [torch.tensor(p, dtype=torch.long, device=dev) for p in pushes]
    data = dia.data.to(adt)
    shifts = [lo + max(-n, min(n, o)) for o in dia.offsets]
    for s in range(int(k)):
        src, dst = s % 2, (s + 1) % 2
        acc = torch.zeros(n, dtype=adt, device=dev)
        for d, sh in enumerate(shifts):
            acc = acc + data[d] * bufs[rank, src, slot + sh]
        if s == int(k) - 1:
            return acc
        bufs[rank, dst, lo + slot] = acc
        for t, rows_in in enumerate(pushes):
            bufs[t, dst, rows_in - t * rows + lo] = acc[rows_in]
        full = torch.where(inside, acc[row_of.clamp(0, max(n - 1, 0))], 0)
        if not torch.equal(bufs[live, dst], full[live]):
            raise AssertionError("a CTA's next buffer misses part of its rows or halo")


def dia_spmv_chain(dia: DIA, x: torch.Tensor, k: int, plan: ChainPlan | None = None
                   ) -> torch.Tensor:
    """x ← Aᵏ x (square A), in the accumulation dtype of the operands.
    CUDA: one launch of the kernel of ``plan`` (by default
    ``dia_chain_plan``'s choice); a failed launch raises.  CPU: the plain
    version."""
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
    plan = dia_chain_plan(dia, adt) if plan is None else plan
    if plan.dtype != adt:
        raise ValueError(f"dia_spmv_chain: a plan for {plan.dtype} on {adt} operands")
    n, n_d = dia.shape[0], len(dia.offsets)
    sfx = _CHAIN_SUFFIX[adt]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.kernel == "cluster":
            lo, hi = chain_halos(dia.offsets, n)
            rc = getattr(_kernels(), f"smt_dia_chain_cluster_{sfx}")(
                data.data_ptr(), dia.offsets_dev.data_ptr(), n_d, n, plan.rows, lo, hi,
                x.data_ptr(), out.data_ptr(), k, plan.blocks, plan.threads, plan.smem,
                stream)
        else:
            tmp = torch.empty_like(x) if k > 1 else out
            rc = getattr(_kernels(), f"smt_dia_chain_{sfx}")(
                data.data_ptr(), dia.offsets_dev.data_ptr(), n_d, n, x.data_ptr(),
                out.data_ptr(), tmp.data_ptr(), k, plan.blocks, stream)
    _check(rc, f"dia_spmv_chain ({plan.kernel} kernel)")
    LAUNCHES["dia_spmv_chain"] += 1
    CHAIN_KERNELS[plan.kernel] += 1
    return out
