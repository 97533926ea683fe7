"""Checkpoint / resume (counterpart of ``sparsemat_tpu/checkpoint.py``),
in the JAX package's file format, so each package loads what the other
saves.

* ``save_matrix`` / ``load_matrix``: a frozen format round-trips through one
  ``.npz`` file, version 2 of the JAX package's layout: a JSON
  ``__header__`` ``{"version": 2, "root": node}`` where a format node is
  ``{"format": class name, "static": {...}, "fields": {...}}`` and each
  field is ``{"kind": "array", "key": npz key}``, ``{"kind": "tuple",
  "items": [...]}``, ``{"kind": "format", "value": node}`` or ``{"kind":
  "none"}``.  Tensors are the array fields; ints, bools and tuples of ints
  (shape, offsets, block ids) are static.  The version-1 flat layout (one
  header with ``format`` and ``static``, arrays under their field names) is
  read too.  The port's formats are COO, CSR, DIA, ELL, SELL, BSR,
  StripELL (with its StripPart), RouteStream, SlabELL, SlabPack (its parts
  and overflow nested), SlabStream, WELL and GELL (its ELL levels nested);
  a file holding another format raises ``ValueError``.  An absent optional
  field (BSR ``occ``, SlabELL ``bucket_cnt``, SlabPack ``overflow``, WELL
  ``row_cnt``) is written as ``none``.  A DIA from the JAX package carries
  ``tdata`` (its TPU lane-packed copy), a BSR and a WELL ``chunks`` (their
  TPU call ranges): each is read and dropped.  The port writes ``tdata`` as
  ``none`` and a WELL's ``chunks`` as the JAX freeze computes them
  (``formats.well.chunk_bounds``), so the JAX package's TPU kernel runs on
  a WELL the port saved.
* ``save_solve_state`` / ``load_solve_state`` / ``resume``: (x, iterations,
  residual norm); a resumed solve is a fresh solve from the checkpointed
  iterate, its iteration count offset by the checkpoint's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple

import numpy as np
import torch

from .formats.base import SparseFormat, to_device
from .formats.bsr import BSR
from .formats.coo import COO
from .formats.csr import CSR
from .formats.dia import DIA
from .formats.ell import ELL
from .formats.gell import GELL
from .formats.route import RouteStream
from .formats.sell import SELL
from .formats.slab import SlabELL, SlabPack, SlabStream
from .formats.strip import StripELL, StripPart
from .formats.well import WELL, chunk_bounds
from .types import resolve_device

_FORMATS = {cls.__name__: cls for cls in (COO, CSR, DIA, ELL, SELL, BSR, StripELL, StripPart,
                                          RouteStream, SlabELL, SlabPack, SlabStream, WELL,
                                          GELL)}
#: fields the JAX package writes and the port has no use for, read and
#: dropped on load.  On save each is written by its entry: None writes an
#: absent array field (DIA's lane-packed copy, BSR's TPU call chunks); a
#: function writes the static the JAX constructor requires (WELL's TPU call
#: chunks, as the JAX freeze computes them)
_DROPPED = {"DIA": {"tdata": None}, "BSR": {"chunks": None},
            "WELL": {"chunks": lambda m: chunk_bounds(m.host("tile_rows"), m.n_row_blocks)}}


def _format_class(name: str):
    cls = _FORMATS.get(name)
    if cls is None:
        raise ValueError(f"checkpoint holds a {name!r}, a format the port does not "
                         f"have yet (it has {sorted(_FORMATS)})")
    return cls


def _host_array(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise TypeError("save_matrix: numpy has no bfloat16; cast the matrix "
                        "(astype) to float32 before saving")
    return t.detach().cpu().numpy()


def _is_field(v) -> bool:
    """Whether a dataclass value is an array field (tensor, format, a tuple
    of them, or an absent optional one: BSR's ``occ``, SlabELL's
    ``bucket_cnt``, SlabPack's ``overflow``) rather than static metadata."""
    if v is None or isinstance(v, (torch.Tensor, SparseFormat)):
        return True
    return isinstance(v, (tuple, list)) and any(_is_field(e) for e in v)


def _flatten_field(v, key: str, arrays: dict) -> dict:
    if v is None:
        return {"kind": "none"}
    if isinstance(v, SparseFormat):
        return {"kind": "format", "value": _flatten_format(v, key + ".", arrays)}
    if isinstance(v, (tuple, list)):
        return {"kind": "tuple",
                "items": [_flatten_field(e, f"{key}.{i}", arrays) for i, e in enumerate(v)]}
    arrays[key] = _host_array(v)
    return {"kind": "array", "key": key}


def _flatten_format(mat, prefix: str, arrays: dict) -> dict:
    name = type(mat).__name__
    _format_class(name)
    desc = {"format": name, "static": {}, "fields": {}}
    for f in dataclasses.fields(mat):
        v = getattr(mat, f.name)
        if _is_field(v):
            desc["fields"][f.name] = _flatten_field(v, prefix + f.name, arrays)
        else:
            desc["static"][f.name] = v
    for name_, write in _DROPPED.get(name, {}).items():
        if write is None:
            desc["fields"][name_] = {"kind": "none"}
        else:
            desc["static"][name_] = write(mat)
    return desc


def _untuple(v):
    # JSON turns tuples into lists, nested ones included
    return tuple(_untuple(e) for e in v) if isinstance(v, list) else v


def _build(cls, kwargs: dict, host: dict):
    mat = cls(**kwargs)
    return mat._stash_host(**host) if host else mat


def _unflatten_field(node, z, device, host: dict, name: str):
    kind = node["kind"]
    if kind == "none":
        return None
    if kind == "format":
        return _unflatten_format(node["value"], z, device)
    if kind == "tuple":
        return tuple(_unflatten_field(e, z, device, {}, name) for e in node["items"])
    a = z[node["key"]]
    host[name] = a
    return to_device(a, None, device)


def _unflatten_format(desc: dict, z, device):
    name = desc["format"]
    cls = _format_class(name)
    dropped = _DROPPED.get(name, {})
    kwargs = {k: _untuple(v) for k, v in desc["static"].items() if k not in dropped}
    host = {}
    for fname, node in desc["fields"].items():
        if fname in dropped:
            continue
        kwargs[fname] = _unflatten_field(node, z, device, host, fname)
    return _build(cls, kwargs, host)


def save_matrix(path: str, mat) -> None:
    """Serialise a frozen format (nested ones included) to ``.npz``."""
    if not isinstance(mat, SparseFormat):
        raise TypeError(f"cannot checkpoint {type(mat).__name__}: freeze the "
                        "builder to a format first")
    arrays = {}
    desc = _flatten_format(mat, "", arrays)
    header = json.dumps({"version": 2, "root": desc}, default=int)  # numpy ints
    np.savez(path, __header__=np.frombuffer(header.encode(), np.uint8), **arrays)


def load_matrix(path: str, *, device=None):
    """A matrix saved by either package's ``save_matrix``, uploaded to
    ``device`` (None: the current CUDA card; host arrays cached)."""
    device = resolve_device(device)
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if "root" in header:
            return _unflatten_format(header["root"], z, device)
        # version 1: a flat format, arrays under their field names
        cls = _format_class(header["format"])
        kwargs = {k: _untuple(v) for k, v in header["static"].items()}
        host = {f.name: z[f.name] for f in dataclasses.fields(cls) if f.name in z.files}
        kwargs.update({k: to_device(a, None, device) for k, a in host.items()})
        return _build(cls, kwargs, host)


class SolveState(NamedTuple):
    """Resumable solver checkpoint."""

    x: np.ndarray
    iterations: int
    residual_norm: float


def save_solve_state(path: str, x, info=None) -> None:
    """Checkpoint a (possibly partial) solve: the iterate and its progress."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    np.savez(path, x=x,
             iterations=np.int64(int(info.iterations) if info is not None else 0),
             residual_norm=np.float64(
                 float(info.residual_norm) if info is not None else np.inf))


def load_solve_state(path: str) -> SolveState:
    with np.load(path) as z:
        return SolveState(x=z["x"], iterations=int(z["iterations"]),
                          residual_norm=float(z["residual_norm"]))


def resume(solver_fn, A, b, state: SolveState, **kw):
    """Continue a checkpointed solve: ``solver_fn(A, b, x0=state.x, **kw)``
    with the reported iteration count offset by the checkpoint's."""
    x, info = solver_fn(A, b, x0=torch.from_numpy(np.asarray(state.x)), **kw)
    return x, info._replace(iterations=info.iterations + state.iterations)
