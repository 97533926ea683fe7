"""Carry the JAX package's frozen state into the port.

``from_reference`` builds the port's ``COO``/``CSR``/``DIA``/``ELL``/``SELL``/
``BSR``/``StripELL``/``RouteStream``/``SlabELL``/``SlabPack``/``SlabStream``/
``WELL``/``GELL`` from the JAX package's frozen arrays handed over as numpy
(``np.asarray(jax_csr.indptr)`` and so on), so both packages compute on the
same matrix and the same frozen layout; and the rank's part of a
``DistDIA``/``DistCSR``/``DistELL``/``DistCSRSubset``/``DistSlab`` from the
JAX object's global arrays, so both compute on the same partition.  Nothing
of the JAX package is imported.
"""

from __future__ import annotations

import numpy as np

from .formats.base import to_device
from .formats.bsr import BSR
from .formats.coo import COO
from .formats.csr import CSR
from .formats.dia import DIA
from .formats.ell import ELL
from .formats.gell import GELL
from .formats.route import ARRAYS as _ROUTE_ARRAYS
from .formats.route import RouteStream
from .formats.sell import SELL
from .formats.slab import SlabELL, SlabPack, SlabStream
from .formats.strip import StripELL, StripPart
from .formats.well import WELL
from .parallel.dist import DistCSR, DistCSRSubset, DistDIA, DistELL, DistSlab
from .parallel.mesh import ROWS_AXIS
from .types import resolve_device

_FIELDS = {"coo": ("rows", "cols", "vals"),
           "csr": ("indptr", "indices", "data", "row_ids"),
           "dia": ("data",),
           "ell": ("cols", "vals", "row_nnz"),
           "bsr": ("blocks", "block_rows", "block_cols", "occ"),
           "route": _ROUTE_ARRAYS,
           "well": ("vals", "lidx", "tile_rows", "tile_wins", "row_cnt"),
           "slab_stream": ("vals", "lidx", "win_id", "blk_id", "cnt8", "row_block"),
           "sell": ("slot_rows", "slot_cols", "slot_vals", "slice_offsets", "slice_height")}
#: fields the port has no use for: DIA's lane-packed copy for the TPU
#: tiling, BSR's and WELL's TPU call chunks
_IGNORED = {"dia": ("tdata",), "bsr": ("chunks",), "well": ("chunks",)}
#: fields that may be None (absent)
_OPTIONAL = {"bsr": ("occ",), "well": ("row_cnt",)}
#: static (integer) fields
_STATIC = {"slab_stream": ("row_block",), "sell": ("slice_height",)}
_CLASSES = {"well": WELL, "slab_stream": SlabStream, "sell": SELL}
#: a GELL's fields: levels (ELL dicts), inv_maps, level_rows
_GELL_FIELDS = ("levels", "inv_maps", "level_rows")
#: a StripELL part's arrays and static fields
_STRIP_ARRAYS = ("vals", "lidx", "wrel", "wtile", "occ")
_STRIP_STATIC = ("block_ids", "g4", "lidx_pack")
#: a SlabELL's arrays (``bucket_cnt`` may be None) and static field
_SLAB_ARRAYS = ("vals", "lidx", "win_lo", "bucket_cnt")
_SLAB_STATIC = ("buckets",)
#: a SlabPack's fields
_PACK_FIELDS = ("parts", "block_ids", "row_block", "overflow")
#: the row-partitioned formats: each takes its global arrays (a leading
#: block axis) and its static fields in ``fields``
_DIST = {"dist_dia": (DistDIA, ("data",)),
         "dist_csr": (DistCSR, ("indptr", "indices", "data", "local_rows")),
         "dist_ell": (DistELL, ("cols", "vals")),
         "dist_csr_subset": (DistCSRSubset, ("send_idx", "indices", "data", "local_rows",
                                             "hop_m", "rpb")),
         "dist_slab": (DistSlab, ("vals", "lidx", "win_lo", "buckets", "halo_windows",
                                  "local_windows"))}


def from_reference(fields: dict, *, format: str, shape, offsets=None,
                   device=None, mesh=None, axis: str = ROWS_AXIS):
    """The port's format ``format`` ('coo', 'csr', 'dia', 'ell', 'sell',
    'bsr', 'strip', 'route', 'slab', 'slab_pack', 'slab_stream', 'well' or
    'gell') from the JAX package's frozen arrays ``fields`` (name → numpy
    array), on ``device`` (None: the current CUDA card).  A DIA needs
    ``offsets``; a DIA's ``tdata`` and a BSR's and a WELL's ``chunks`` are
    accepted and ignored; a BSR's ``occ`` and a WELL's ``row_cnt`` may be
    None.  A SlabStream takes its arrays and ``row_block``, a SELL its
    arrays and ``slice_height``.  A GELL takes ``levels`` (each an ELL's
    dict of cols, vals, row_nnz and ``shape``), ``inv_maps`` and
    ``level_rows``.  A RouteStream takes its 17
    arrays.  A StripELL takes ``{"parts": [part, ...]}``, each part a dict
    of its arrays (vals, lidx, wrel, wtile, occ) and static fields
    (block_ids, g4, lidx_pack).  A SlabELL takes its arrays (vals, lidx,
    win_lo, bucket_cnt, which may be None) and ``buckets``; a SlabPack
    ``{"parts": [slab, ...], "block_ids", "row_block", "overflow"}``, each
    part a SlabELL's dict and the overflow a SlabPack's dict or None.

    The row-partitioned formats ('dist_dia', 'dist_csr', 'dist_ell',
    'dist_csr_subset', 'dist_slab') take the JAX object's global arrays
    (``np.asarray(d.indptr)``, a DistCSRSubset's ``send_idx`` as a tuple of
    them) and its static fields by their names (``hop_m``, ``rpb``;
    ``buckets``, ``halo_windows``, ``local_windows``), the row ``mesh``
    (its size the block count) and its ``axis``; a DistDIA needs
    ``offsets``.  They return this rank's part, on the mesh's device."""
    shape = tuple(int(s) for s in shape)
    if format in _DIST:
        cls, need = _DIST[format]
        _check_fields(format, fields, need)
        if mesh is None:
            raise ValueError(f"{format}: a mesh is required")
        if format == "dist_dia":
            if offsets is None:
                raise ValueError("dist_dia: offsets are required")
            return cls.from_global(fields, shape=shape, offsets=offsets, mesh=mesh, axis=axis)
        return cls.from_global(fields, shape=shape, mesh=mesh, axis=axis)
    device = resolve_device(device)
    if format == "gell":
        return _gell(fields, shape, device)
    if format == "strip":
        if set(fields) != {"parts"}:
            raise ValueError(f"strip: expected the field 'parts', got {sorted(fields)}")
        return StripELL(parts=tuple(_strip_part(p, shape, device)
                                    for p in fields["parts"]), shape=shape)
    if format == "slab":
        return _slab(fields, shape, device)
    if format == "slab_pack":
        return _slab_pack(fields, shape, device)
    if format not in _FIELDS:
        raise ValueError(f"unknown format {format!r}; expected one of "
                         f"{sorted(_FIELDS) + ['gell', 'slab', 'slab_pack', 'strip']}"
                         f" or {sorted(_DIST)}")
    need = _FIELDS[format]
    _check_fields(format, fields, need, _IGNORED.get(format, ()))
    static = {f: int(fields[f]) for f in _STATIC.get(format, ())}
    host = {f: np.asarray(fields[f]) for f in need if f not in static
            and not (f in _OPTIONAL.get(format, ()) and fields[f] is None)}
    if format in _CLASSES:
        arrays = {f: to_device(host[f], None, device) if f in host else None
                  for f in need if f not in static}
        return _CLASSES[format](**arrays, **static, shape=shape)._stash_host(**host)
    if format == "route":
        return RouteStream.from_host(host, shape, device=device)
    t = {f: to_device(a, None, device) for f, a in host.items()}
    if format == "coo":
        return COO(rows=t["rows"], cols=t["cols"], vals=t["vals"], shape=shape)
    if format == "csr":
        return CSR(shape=shape, **t)._stash_host(**host)
    if format == "ell":
        return ELL(shape=shape, **t)
    if format == "bsr":
        return BSR(blocks=t["blocks"], block_rows=t["block_rows"],
                   block_cols=t["block_cols"], occ=t.get("occ"),
                   shape=shape)._stash_host(**host)
    if offsets is None:
        raise ValueError("dia: offsets are required")
    return DIA(data=t["data"], offsets=tuple(int(o) for o in offsets), shape=shape)


def _check_fields(what: str, fields: dict, need, ignored=()) -> None:
    missing = [f for f in need if f not in fields]
    extra = set(fields) - set(need) - set(ignored)
    if missing or extra:
        raise ValueError(f"{what}: missing fields {missing}, unknown fields {sorted(extra)}")


def _slab(fields: dict, shape, device) -> SlabELL:
    _check_fields("slab", fields, _SLAB_ARRAYS + _SLAB_STATIC)
    host = {f: np.asarray(fields[f]) for f in _SLAB_ARRAYS if fields[f] is not None}
    sl = SlabELL(**{f: to_device(host[f], None, device) if f in host else None
                    for f in _SLAB_ARRAYS},
                 shape=shape, buckets=tuple((int(o), int(h)) for o, h in fields["buckets"]))
    return sl._stash_host(**host)


def _slab_pack(fields: dict, shape, device) -> SlabPack:
    _check_fields("slab_pack", fields, _PACK_FIELDS)
    rb = int(fields["row_block"])
    ids = tuple(tuple(int(b) for b in i) for i in fields["block_ids"])
    parts = tuple(_slab(p, (len(i) * rb, shape[1]), device)
                  for p, i in zip(fields["parts"], ids))
    overflow = fields["overflow"]
    return SlabPack(parts=parts, block_ids=ids, shape=shape, row_block=rb,
                    overflow=None if overflow is None else _slab_pack(overflow, shape, device))


def _ell(fields: dict, device) -> ELL:
    _check_fields("gell level", fields, ("cols", "vals", "row_nnz", "shape"))
    return ELL(**{f: to_device(np.asarray(fields[f]), None, device)
                  for f in ("cols", "vals", "row_nnz")},
               shape=tuple(int(s) for s in fields["shape"]))


def _gell(fields: dict, shape, device) -> GELL:
    _check_fields("gell", fields, _GELL_FIELDS)
    return GELL(levels=tuple(_ell(lvl, device) for lvl in fields["levels"]),
                **{f: tuple(to_device(np.asarray(a), None, device) for a in fields[f])
                   for f in ("inv_maps", "level_rows")},
                shape=shape)


def _strip_part(part: dict, shape, device) -> StripPart:
    _check_fields("strip part", part, _STRIP_ARRAYS + _STRIP_STATIC)
    host = {f: np.asarray(part[f]) for f in _STRIP_ARRAYS}
    return StripPart(**{f: to_device(a, None, device) for f, a in host.items()},
                     block_ids=tuple(int(b) for b in part["block_ids"]),
                     shape=shape, g4=int(part["g4"]),
                     lidx_pack=int(part["lidx_pack"]))._stash_host(**host)
