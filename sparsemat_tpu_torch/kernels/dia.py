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

The SpMV and its dot run one kernel over a persistent grid of row tiles
(``dia_spmv_plan`` sizes it, a pure function of the shape, the offsets,
the item size and the card's SMs and occupancy, cached on the matrix); the
dot is finished in the same launch, by the last CTA, into a 0-d tensor.

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
from dataclasses import dataclass, field, replace

import torch

from ..formats.dia import DIA
from ..formats.dia import dia_spmv as dia_spmv_ref
from ..types import FLOAT_DTYPES, accum_dtype
from ..utils import profiling
from .._build import load_cuda

#: kernel launches per wrapper (plain versions do not count)
LAUNCHES = profiling.register("kernels.dia", {"dia_spmv": 0, "dia_spmv_dot": 0,
                                              "dia_spmv_chain": 0})
#: chain launches by kernel: the cluster kernel or the cooperative grid
CHAIN_KERNELS = {"cluster": 0, "grid": 0}

#: diagonal counts the SpMV kernel is compiled for (``csrc/dia.cu``
#: SMT_DIA_SPEC_COUNTS): the tridiagonal bands (3) and the 2-D 5-point
#: Poisson and benchmark bands (5); any other count runs the kernel's loop
#: over diagonals
SPECIALISED = (3, 5)
#: threads of an SpMV CTA (``csrc/dia.cu`` SPMV_THREADS)
SPMV_THREADS = 256

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
_spmv_occupancy: dict = {}
_dot_scratch: dict = {}


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
            fn.argtypes = [ctypes.POINTER(SpmvLaunch), vp, vp, vp, vp, vp, vp, vp]
            fn.restype = i32
            fn = getattr(lib, f"smt_dia_spmv_occupancy_{s}")
            fn.argtypes = [i32, i32, ctypes.POINTER(i32)]
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
        lib.smt_dia_spmv_threads.restype = i32
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
    Raises on anything the kernels do not take.  A promoted ``data`` is
    made once per dtype and kept on the matrix (a DIA is frozen), so mixed
    operands copy only x on each call."""
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
    return promoted_data(dia, dtype), x if x.dtype == dtype else x.to(dtype)


def promoted_data(dia: DIA, dtype: torch.dtype) -> torch.Tensor:
    """``dia.data`` in ``dtype``: itself, or a copy made once and cached on
    the matrix."""
    if dia.data.dtype == dtype:
        return dia.data
    cache = dia.__dict__.get("_promoted")
    if cache is None:
        cache = {}
        object.__setattr__(dia, "_promoted", cache)
    if dtype not in cache:
        cache[dtype] = dia.data.to(dtype)
    return cache[dtype]


def _require_square(dia: DIA, what: str) -> None:
    if dia.shape[0] != dia.shape[1]:
        raise ValueError(f"{what} needs a square matrix, got {dia.shape}")


# --- the SpMV's plan ----------------------------------------------------------

class SpmvLaunch(ctypes.Structure):
    """One SpMV launch's plan as ``csrc/dia.cu`` reads it (``SpmvLaunch``)."""
    _fields_ = [("offs", ctypes.c_void_p), ("offs_host", ctypes.c_void_p),
                ("n_d", ctypes.c_int), ("nd_spec", ctypes.c_int), ("vec", ctypes.c_int),
                ("grid", ctypes.c_int), ("n_rows", ctypes.c_int64), ("n_cols", ctypes.c_int64),
                ("tiles", ctypes.c_int64), ("lo_tile", ctypes.c_int64),
                ("hi_tile", ctypes.c_int64)]


@dataclass(frozen=True)
class SpmvPlan:
    """How the SpMV kernel walks one matrix.  Each thread owns ``vec``
    consecutive rows of a tile of ``tile`` = ``SPMV_THREADS`` · vec rows;
    ``grid`` CTAs walk the ``tiles`` tiles, CTA b taking b, b + grid, ….
    Tiles in ``interior`` = [lo, hi) read no row past n_rows and no x
    outside [0, n_cols); the others (``edge_tiles``) test each element.
    ``n_d``: the diagonal count the kernel is compiled for, or 0 for its
    loop.  ``near``: the diagonals whose offset is not a multiple of vec,
    whose x straddles two aligned vectors (the next lane's, by shuffle);
    ``far``: the others, one aligned vector each.  ``offsets_host``: the
    offsets as a C array, for the compiled counts' parameters; ``launch``:
    the plan as the kernel's C struct, for a matrix on the card."""
    vec: int
    tile: int
    tiles: int
    n_d: int
    grid: int
    interior: tuple[int, int]
    near: tuple[int, ...]
    far: tuple[int, ...]
    offsets_host: object = field(default=None, compare=False, repr=False)
    launch: object = field(default=None, compare=False, repr=False)

    @property
    def edge_tiles(self) -> list[int]:
        lo, hi = self.interior
        return [t for t in range(self.tiles) if not lo <= t < hi]


def spmv_vec(n_rows: int, itemsize: int) -> int:
    """Rows a thread: a 16-byte vector of values (4 f32, 2 f64, 8 bf16/f16)
    where each diagonal's slice starts 16-byte aligned (n_rows · itemsize a
    multiple of 16), else 1."""
    v = 16 // itemsize
    return v if n_rows % v == 0 else 1


def spmv_plan(n_rows: int, n_cols: int, offsets, itemsize: int, sms: int, per_sm,
              threads: int = SPMV_THREADS, aligned: bool = True) -> SpmvPlan:
    """The SpMV kernel's plan, a pure function of the shape, the offsets,
    the item size and the card: ``sms`` SMs each holding ``per_sm(vec,
    n_d)`` CTAs of the instantiation.  ``aligned`` False (a data or x
    pointer not 16-byte aligned) takes vec = 1."""
    offsets = tuple(int(o) for o in offsets)
    vec = spmv_vec(n_rows, itemsize) if aligned else 1
    n_d = len(offsets) if vec > 1 and len(offsets) in SPECIALISED else 0
    tile = threads * vec
    tiles = max(1, -(-n_rows // tile))
    q = [o // vec for o in offsets]
    near = tuple(d for d, o in enumerate(offsets) if o % vec)
    far = tuple(d for d, o in enumerate(offsets) if not o % vec)
    # a tile at base reads, for diagonal d, x over [base + q·vec, base +
    # tile + q·vec), and one vector more where the offset is near
    reach_lo = max([0] + [-qd * vec for qd in q])
    reach_hi = max([0] + [qd * vec + (vec if o % vec else 0) for qd, o in zip(q, offsets)])
    lo = -(-reach_lo // tile)
    hi = (min(n_rows, n_cols - reach_hi) - tile) // tile + 1
    hi = min(max(hi, lo), tiles)
    lo = min(lo, hi)
    grid = max(1, min(sms * max(1, per_sm(vec, n_d)), tiles))
    return SpmvPlan(vec, tile, tiles, n_d, grid, (lo, hi), near, far,
                    (ctypes.c_int64 * max(1, len(offsets)))(*offsets))


def _occupancy(device: torch.device, dtype: torch.dtype):
    """CTAs an SM of ``device`` holds, as a function of the instantiation
    (vec, n_d), read from the card once each."""
    def per_sm(vec, n_d):
        key = (device, dtype, vec, n_d)
        if key not in _spmv_occupancy:
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                rc = getattr(_kernels(), f"smt_dia_spmv_occupancy_{_SUFFIX[dtype]}")(
                    n_d, vec, ctypes.byref(n))
            _check(rc, "dia_spmv_plan")
            if n.value < 1:
                raise RuntimeError(f"dia_spmv_plan: an SM of {device} holds no CTA of the "
                                   f"SpMV kernel (vec {vec}, n_d {n_d})")
            _spmv_occupancy[key] = n.value
        return _spmv_occupancy[key]
    return per_sm


def dia_spmv_plan(dia: DIA, dtype: torch.dtype, device, aligned: bool = True) -> SpmvPlan:
    """``spmv_plan`` for this DIA run in ``dtype`` on the CUDA ``device``,
    from the card's SM count and occupancy, with its ``launch`` struct;
    cached on the matrix (a build is the set-up span ``freeze.plan``)."""
    key = (dtype, device, aligned)
    cache = dia.__dict__.get("_spmv_plans")
    if cache is None:
        cache = {}
        object.__setattr__(dia, "_spmv_plans", cache)
    plan = cache.get(key)
    if plan is None:
        with profiling.span("freeze.plan", setup=True):
            device = torch.device(device)
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            plan = spmv_plan(dia.shape[0], dia.shape[1], dia.offsets, dtype.itemsize, sms,
                             _occupancy(device, dtype), _kernels().smt_dia_spmv_threads(),
                             aligned)
            launch = SpmvLaunch(dia.offsets_dev.data_ptr(),
                                ctypes.addressof(plan.offsets_host), len(dia.offsets),
                                plan.n_d, plan.vec, plan.grid, dia.shape[0], dia.shape[1],
                                plan.tiles, *plan.interior)
            plan = cache[key] = replace(plan, launch=launch)
    return plan


def dot_scratch(device: torch.device, stream: int):
    """(partials, counter) of the fused dot: room for every CTA of any plan
    (an SM holds at most 32), 8 bytes each, and an unsigned counter at 0
    that each launch leaves at 0.

    An eager launch takes the pair of its (device, stream), made and zeroed
    at its first launch there, so launches on two streams never share a
    counter.  A launch being captured into a CUDA graph takes a pair of its
    own, made from the graph's memory pool, whose counter is zeroed by a
    fill that the graph replays just before the kernel: so no replay reads
    a counter that another graph, or an eager launch on the capture's
    stream, left in use, and two graphs replayed at once on two streams
    share nothing.  The cost is one 4-byte fill node per captured launch.
    The eager pairs are bounded by PyTorch's pool of streams per device
    (and any external streams)."""
    def made():
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return (torch.empty(32 * sms, dtype=torch.float64, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))

    if torch.cuda.is_current_stream_capturing():
        return made()
    key = (device, stream)
    if key not in _dot_scratch:
        _dot_scratch[key] = made()
    return _dot_scratch[key]


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_spmv(dia: DIA, x: torch.Tensor, with_dot: bool, what: str,
                 launches: dict = LAUNCHES):
    """y (and the 0-d dot) by one launch of the SpMV kernel, counted in
    ``launches[what]``."""
    data, x = _operands(dia, x, what)
    dev = x.device
    plan = dia_spmv_plan(dia, data.dtype, dev, aligned=_aligned(data, x))
    adt = accum_dtype(data.dtype)
    y = torch.empty(dia.shape[0], dtype=adt, device=dev)
    dot = torch.empty((), dtype=adt, device=dev) if with_dot else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        partials, counter = dot_scratch(dev, stream) if with_dot else (None, None)
        rc = getattr(_kernels(), f"smt_dia_spmv_{_SUFFIX[data.dtype]}")(
            plan.launch, data.data_ptr(), x.data_ptr(), y.data_ptr(), _ptr(partials),
            _ptr(counter), _ptr(dot), stream)
    _check(rc, what)
    launches[what] += 1
    return y, dot


def _ptr(t):
    return None if t is None else t.data_ptr()


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

def dia_spmv(dia: DIA, x: torch.Tensor, launches: dict = LAUNCHES,
             name: str = "dia_spmv") -> torch.Tensor:
    """y = A @ x.  CUDA: one launch of ``dia_spmv_kernel`` over the
    matrix's plan, counted in ``launches[name]``; CPU: the plain version."""
    if _on_cpu(dia, x):
        return dia_spmv_ref(dia, x)
    y, _ = _launch_spmv(dia, x, with_dot=False, what=name, launches=launches)
    return y


def dia_spmv_dot(dia: DIA, x: torch.Tensor):
    """(A @ x, x·(A @ x)) in one pass over the matrix (square A) — CG's
    A·p and pᵀAp.  CUDA: one launch, which also sums the dot (a 0-d tensor
    in the accumulation dtype) in a fixed order, so reruns are bitwise
    equal; CPU: the plain version."""
    _require_square(dia, "dia_spmv_dot")
    if _on_cpu(dia, x):
        return dia_spmv_dot_ref(dia, x)
    return _launch_spmv(dia, x, with_dot=True, what="dia_spmv_dot")


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
