"""Carry the JAX package's frozen state into the port.

``from_reference`` builds the port's ``COO``/``CSR``/``DIA``/``StripELL``/
``RouteStream`` from the JAX package's frozen arrays handed over as numpy
(``np.asarray(jax_csr.indptr)`` and so on), so both packages compute on the
same matrix and the same frozen layout.  Nothing of the JAX package is
imported.
"""

from __future__ import annotations

import numpy as np

from .formats.base import to_device
from .formats.coo import COO
from .formats.csr import CSR
from .formats.dia import DIA
from .formats.route import ARRAYS as _ROUTE_ARRAYS
from .formats.route import RouteStream
from .formats.strip import StripELL, StripPart

_FIELDS = {"coo": ("rows", "cols", "vals"),
           "csr": ("indptr", "indices", "data", "row_ids"),
           "dia": ("data",),
           "route": _ROUTE_ARRAYS}
#: fields the port has no use for: DIA's lane-packed copy for the TPU tiling
_IGNORED = {"dia": ("tdata",)}
#: a StripELL part's arrays and static fields
_STRIP_ARRAYS = ("vals", "lidx", "wrel", "wtile", "occ")
_STRIP_STATIC = ("block_ids", "g4", "lidx_pack")


def from_reference(fields: dict, *, format: str, shape, offsets=None,
                   device=None):
    """The port's format ``format`` ('coo', 'csr', 'dia', 'strip' or 'route')
    from the JAX package's frozen arrays ``fields`` (name → numpy array), on
    ``device``.  A DIA needs ``offsets``; a DIA's ``tdata`` is accepted and
    ignored.  A RouteStream takes its 17 arrays.  A StripELL takes ``{"parts": [part, ...]}``, each part a dict
    of its arrays (vals, lidx, wrel, wtile, occ) and static fields
    (block_ids, g4, lidx_pack)."""
    shape = tuple(int(s) for s in shape)
    if format == "strip":
        if set(fields) != {"parts"}:
            raise ValueError(f"strip: expected the field 'parts', got {sorted(fields)}")
        return StripELL(parts=tuple(_strip_part(p, shape, device)
                                    for p in fields["parts"]), shape=shape)
    if format not in _FIELDS:
        raise ValueError(f"unknown format {format!r}; expected one of "
                         f"{sorted(_FIELDS) + ['strip']}")
    need = _FIELDS[format]
    missing = [f for f in need if f not in fields]
    extra = set(fields) - set(need) - set(_IGNORED.get(format, ()))
    if missing or extra:
        raise ValueError(f"{format}: missing fields {missing}, unknown fields {sorted(extra)}")
    host = {f: np.asarray(fields[f]) for f in need}
    if format == "route":
        return RouteStream.from_host(host, shape, device=device)
    t = {f: to_device(a, None, device) for f, a in host.items()}
    if format == "coo":
        return COO(rows=t["rows"], cols=t["cols"], vals=t["vals"], shape=shape)
    if format == "csr":
        return CSR(shape=shape, **t)._stash_host(**host)
    if offsets is None:
        raise ValueError("dia: offsets are required")
    return DIA(data=t["data"], offsets=tuple(int(o) for o in offsets), shape=shape)


def _strip_part(part: dict, shape, device) -> StripPart:
    need = _STRIP_ARRAYS + _STRIP_STATIC
    missing = [f for f in need if f not in part]
    extra = set(part) - set(need)
    if missing or extra:
        raise ValueError(f"strip part: missing fields {missing}, unknown "
                         f"fields {sorted(extra)}")
    host = {f: np.asarray(part[f]) for f in _STRIP_ARRAYS}
    return StripPart(**{f: to_device(a, None, device) for f, a in host.items()},
                     block_ids=tuple(int(b) for b in part["block_ids"]),
                     shape=shape, g4=int(part["g4"]),
                     lidx_pack=int(part["lidx_pack"]))._stash_host(**host)
