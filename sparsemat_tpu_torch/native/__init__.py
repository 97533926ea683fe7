"""Native (C++) assembly store and MatrixMarket parser.

The sources are the port's own copies of the JAX package's C++ files,
``csrc/assembly.cc`` and ``csrc/mmio.cc``, compiled with g++ into the port's
build directory (keyed by source hash) and bound with ctypes.  Nothing of
``sparsemat_tpu`` is compiled, read or imported.  When the library cannot be
built, ``get_lib`` returns None (once, loudly): the builder uses its
pure-Python store and ``io.load_mtx`` its numpy reader.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Optional

import numpy as np

from .._build import CSRC_DIR, compile_shared
from ..utils import profiling

_SOURCES = ["assembly.cc", "mmio.cc"]
_GXX = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    vp = ctypes.c_void_p
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    sig = {
        "smt_builder_new": ([ctypes.c_uint64], vp),
        "smt_builder_free": ([vp], None),
        "smt_builder_add_to": ([vp, i64, i64, ctypes.c_double], None),
        "smt_builder_set": ([vp, i64, i64, ctypes.c_double], None),
        "smt_builder_get": ([vp, i64, i64], ctypes.c_double),
        "smt_builder_contains": ([vp, i64, i64], i32),
        "smt_builder_add_batch": ([vp, ctypes.c_uint64, i64p, i64p, f64p], None),
        "smt_builder_set_batch": ([vp, ctypes.c_uint64, i64p, i64p, f64p], None),
        "smt_builder_nnz": ([vp], ctypes.c_uint64),
        "smt_builder_n_rows": ([vp], i64),
        "smt_builder_n_cols": ([vp], i64),
        "smt_builder_export": ([vp, i64p, i64p, f64p], None),
        "smt_builder_export_csr": ([vp, i64p, i64p, f64p], None),
        "smt_builder_scale": ([vp, ctypes.c_double], None),
        "smt_mtx_header": ([ctypes.c_char_p, i64p, i64p, i64p,
                            ctypes.POINTER(i32)], i32),
        "smt_mtx_parse_direct": ([ctypes.c_char_p, vp, vp, i32, vp, i32], i64),
        "smt_mtx_write": ([ctypes.c_char_p, i64, i64, ctypes.c_uint64, vp, i32,
                           vp, i32, vp, i32], i32),
    }
    for name, (argtypes, restype) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it on first call (the set-up span
    ``freeze.build``); None if unavailable."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        srcs = [os.path.join(CSRC_DIR, s) for s in _SOURCES]
        with profiling.span("freeze.build", setup=True):
            _lib = _bind(ctypes.CDLL(compile_shared("smt_native", _GXX, srcs)))
    except (OSError, RuntimeError, AttributeError) as e:
        _lib_error = str(e)
        print(f"sparsemat_tpu_torch: native C++ runtime unavailable, falling "
              f"back to pure-Python paths ({_lib_error})", file=sys.stderr)
    return _lib


def parse_mtx_native(path: str, dtype=np.float32):
    """Parse a MatrixMarket coordinate file → (rows, cols, vals, shape).

    The C++ parser maps the file and writes straight into the returned
    arrays (int32 indices where the shape allows, values in ``dtype``).
    Raises ``ImportError`` without the library and ``ValueError`` on a file
    it cannot parse: "bad header" for a variant it does not take (array
    layout and the like), an entry-count message for a corrupt file."""
    lib = get_lib()
    if lib is None:
        raise ImportError(f"native library unavailable: {_lib_error}")
    nr, nc, nnz = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    flags = ctypes.c_int32()
    rc = lib.smt_mtx_header(path.encode(), ctypes.byref(nr), ctypes.byref(nc),
                            ctypes.byref(nnz), ctypes.byref(flags))
    if rc != 0:
        raise ValueError(f"{path}: not natively parseable (header code {rc})")
    cap = int(nnz.value) * (2 if flags.value & 2 else 1)
    idt = np.int32 if max(nr.value, nc.value) < 2**31 else np.int64
    vdt = np.dtype(dtype)
    if vdt not in (np.dtype(np.float32), np.dtype(np.float64)):
        vdt = np.dtype(np.float64)
    rows = np.empty(cap, idt)
    cols = np.empty(cap, idt)
    vals = np.empty(cap, vdt)
    got = lib.smt_mtx_parse_direct(
        path.encode(), rows.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p), np.dtype(idt).itemsize,
        vals.ctypes.data_as(ctypes.c_void_p), vdt.itemsize)
    if got < 0:
        reasons = {-1: "cannot open/map file", -2: "bad header",
                   -3: "more entries than the header declares",
                   -4: "truncated entry list (fewer entries than declared)"}
        raise ValueError(f"{path}: native parse failed — "
                         f"{reasons.get(int(got), f'code {got}')}")
    got = int(got)
    return (rows[:got], cols[:got],
            vals[:got] if vdt == np.dtype(dtype) else vals[:got].astype(dtype),
            (int(nr.value), int(nc.value)))


def write_mtx_native(path: str, shape, indptr, cols, vals) -> None:
    """Write coordinate/real/general .mtx with the C++ writer from CSR
    arrays: ``indptr`` and ``cols`` of one integer width (int32 or int64),
    ``vals`` f32 or f64, each value in the shortest text that reads back
    to the same value of its dtype."""
    lib = get_lib()
    if lib is None:
        raise ImportError(f"native library unavailable: {_lib_error}")
    idt = np.int64 if max(np.dtype(indptr.dtype).itemsize,
                          np.dtype(cols.dtype).itemsize) > 4 else np.int32
    indptr = np.ascontiguousarray(indptr, idt)
    cols = np.ascontiguousarray(cols, idt)
    vals = np.ascontiguousarray(vals)
    if vals.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        vals = np.ascontiguousarray(vals, np.float64)
    rc = lib.smt_mtx_write(
        path.encode(), int(shape[0]), int(shape[1]), vals.shape[0],
        indptr.ctypes.data_as(ctypes.c_void_p), 1,
        cols.ctypes.data_as(ctypes.c_void_p), int(np.dtype(idt).itemsize),
        vals.ctypes.data_as(ctypes.c_void_p), int(vals.dtype.itemsize))
    if rc != 0:
        raise OSError(f"smt_mtx_write({path!r}) failed with code {rc}")
