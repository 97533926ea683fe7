"""I/O and rendering (counterpart of ``sparsemat_tpu/io.py``).

MatrixMarket: ``load_mtx`` reads a file into the port's ``CSR`` through the
C++ parser (the port's copy of the JAX package's, ``csrc/mmio.cc``, built
in ``native``), with the numpy reader for the variants the
C++ parser does not take; ``save_mtx`` writes coordinate/real/general with
the C++ writer.  Rendering: ``to_string_row``/``to_string`` (dense text)
and ``to_pbm`` (P1 structure bitmap), as the JAX package renders them.
All of it runs on the host; ``load_mtx(..., device=...)`` uploads once (to
the current CUDA card when no device is named).
"""

from __future__ import annotations

import numpy as np

from .formats.csr import CSR
from .types import host_dtype, resolve_device


def _fmt(v) -> str:
    """A value as the shortest text that reads back to it, with no
    trailing zeros (f32 2.24 renders as "2.24")."""
    arr = np.asarray(v)
    if arr.dtype == np.float32:
        s = np.format_float_positional(np.float32(arr), unique=True, trim="-")
    else:
        s = np.format_float_positional(float(arr), unique=True, trim="-")
    return s[:-1] if s.endswith(".") else s


def _dense_row(csr: CSR, i: int) -> np.ndarray:
    ip = csr.host("indptr").astype(np.int64)
    lo, hi = int(ip[i]), int(ip[i + 1])
    row = np.zeros(csr.shape[1], csr.host("data").dtype)
    np.add.at(row, csr.host("indices")[lo:hi].astype(np.int64), csr.host("data")[lo:hi])
    return row


def to_string_row(mat, i: int) -> str:
    """Row i rendered densely with explicit zeros, each value followed by
    one space ("0 2.24 4.12 ")."""
    return "".join(_fmt(v) + " " for v in _dense_row(mat.to_csr(), i))


def to_string(mat) -> str:
    """The whole matrix, one rendered row per line."""
    return "\n".join(to_string_row(mat, i) for i in range(mat.shape[0])) + "\n"


def to_pbm(mat, path: str) -> None:
    """P1 PBM structure bitmap, with the reference's quirks: '1' marks an
    *empty* cell, '0' a stored entry, and each line ends after the row's
    last stored entry."""
    csr = mat.to_csr()
    n_rows, n_cols = csr.shape
    indptr = csr.host("indptr")
    indices = csr.host("indices")
    lines = [f"P1\n{n_cols} {n_rows}"]
    for i in range(n_rows):
        cols = np.sort(indices[indptr[i]:indptr[i + 1]])
        row = []
        last = -1
        for c in cols:
            row.extend(["1"] * (int(c) - last - 1))
            row.append("0")
            last = int(c)
        lines.append(" ".join(row))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# --- MatrixMarket ------------------------------------------------------------

#: which parser handled the last ``load_mtx`` call: "native", "numpy" or None
last_mtx_parser: str | None = None


def load_mtx(path: str, *, dtype=np.float32, index_dtype=np.int32, device=None) -> CSR:
    """A MatrixMarket coordinate or array file as the port's ``CSR`` on
    ``device``.  Real, integer and pattern fields; general, symmetric and
    skew-symmetric symmetries.  The C++ parser reads what it takes; a
    variant it marks as unsupported goes to the numpy reader.  A file whose
    entry count disagrees with its header raises ``ValueError`` and never
    falls back (the numpy reader would load a truncated file as a smaller
    matrix)."""
    global last_mtx_parser
    from .native import parse_mtx_native

    device = resolve_device(device)
    try:
        rows, cols, vals, shape = parse_mtx_native(path, dtype)
        last_mtx_parser = "native"
        return CSR.from_host_coo(rows, cols, vals, shape, dtype=dtype,
                                 index_dtype=index_dtype, device=device)
    except ImportError:
        pass  # no C++ toolchain: the numpy reader
    except ValueError as e:
        if "entries" in str(e):
            raise
    last_mtx_parser = "numpy"
    return _load_mtx_numpy(path, dtype=dtype, index_dtype=index_dtype, device=device)


def _load_mtx_numpy(path: str, *, dtype=np.float32, index_dtype=np.int32,
                    device=None) -> CSR:
    with open(path, "rb") as f:
        header = f.readline().decode().strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket" or header[1] != "matrix":
            raise ValueError(f"{path}: not a MatrixMarket matrix file")
        layout, field, symmetry = header[2], header[3], header[4]
        line = f.readline().decode()
        while line.startswith("%"):
            line = f.readline().decode()
        sizes = line.split()
        if layout == "coordinate":
            n_rows, n_cols, nnz = int(sizes[0]), int(sizes[1]), int(sizes[2])
            if field == "pattern":
                data = np.loadtxt(f, dtype=np.int64, ndmin=2, max_rows=nnz)
                r, c = data[:, 0] - 1, data[:, 1] - 1
                v = np.ones(r.shape[0], dtype)
            else:
                data = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)
                r = data[:, 0].astype(np.int64) - 1
                c = data[:, 1].astype(np.int64) - 1
                v = data[:, 2].astype(dtype)
            if symmetry in ("symmetric", "skew-symmetric"):
                off = r != c
                sign = -1 if symmetry == "skew-symmetric" else 1
                r = np.concatenate([r, c[off]])
                c2 = np.concatenate([c, data[:, 0].astype(np.int64)[off] - 1])
                v = np.concatenate([v, sign * v[off]])
                c = c2
        elif layout == "array":
            n_rows, n_cols = int(sizes[0]), int(sizes[1])
            dense = np.loadtxt(f, dtype=np.float64).reshape(n_cols, n_rows).T
            if symmetry == "symmetric":
                dense = dense + np.tril(dense, -1).T
            r, c = np.nonzero(dense)
            v = dense[r, c].astype(dtype)
        else:
            raise ValueError(f"{path}: unsupported layout {layout!r}")
    return CSR.from_host_coo(r, c, v, (n_rows, n_cols), dtype=dtype,
                             index_dtype=index_dtype, device=device)


def save_mtx(mat, path: str) -> None:
    """Write a sparse matrix as MatrixMarket coordinate/real/general from
    its host arrays (no device read-back for a host-built CSR).  The C++
    writer formats each value in the shortest text that reads back to the
    same value of its dtype; without it, a chunked numpy formatter writes
    9 significant digits for f32 and 17 for f64."""
    from .native import write_mtx_native

    csr = mat if isinstance(mat, CSR) else mat.to_csr()
    indptr = csr.host("indptr").astype(np.int64)
    nnz = int(indptr[-1])
    # int32 unless the shape or nnz overflows it (indptr shares the width)
    idt = np.int32 if max(csr.shape[0], csr.shape[1], nnz) < 2**31 else np.int64
    cols = np.ascontiguousarray(csr.host("indices")[:nnz], idt)
    src_dtype = host_dtype(csr.dtype)
    vals = csr.host("data")[:nnz]
    if np.dtype(vals.dtype) not in (np.dtype(np.float32), np.dtype(np.float64)):
        vals = vals.astype(np.float64)
    try:
        write_mtx_native(path, csr.shape, indptr.astype(idt), cols, vals)
        return
    except ImportError:
        pass
    rows = np.repeat(np.arange(indptr.shape[0] - 1, dtype=np.int64), np.diff(indptr))
    vals = vals.astype(np.float64)
    digits = 9 if src_dtype.itemsize <= 4 else 17
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{csr.shape[0]} {csr.shape[1]} {rows.shape[0]}\n")
        chunk = 1 << 20
        for s in range(0, rows.shape[0], chunk):
            block = np.char.add(
                np.char.add((rows[s:s + chunk] + 1).astype("U"), " "),
                np.char.add(
                    np.char.add((cols[s:s + chunk] + 1).astype("U"), " "),
                    np.asarray([f"{v:.{digits}g}" for v in vals[s:s + chunk]], dtype="U")))
            f.write("\n".join(block.tolist()))
            f.write("\n")
