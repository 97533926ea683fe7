"""Frozen sparse formats: ``COO`` (assembly snapshot), ``CSR`` (canonical
compute), ``DIA`` (banded/stencil), ``ELL`` (rows padded to one length),
``BSR`` (dense blocks, the SpMM format), ``StripELL`` (bounded-span
scattered, the FEM class), ``SlabELL`` and ``SlabPack`` (window-bucketed
slabs for the same class) and ``RouteStream`` (globally scattered, the
circuit class).  The other formats of the JAX package (SELL, GELL, WELL,
SlabStream), and ``auto_format``, are not ported yet."""

from .base import SparseFormat
from .bsr import BSR
from .coo import COO
from .csr import CSR
from .dia import DIA
from .ell import ELL
from .route import RouteStream
from .slab import SlabELL, SlabPack
from .strip import StripELL, StripPart

__all__ = ["SparseFormat", "COO", "CSR", "DIA", "ELL", "BSR", "RouteStream", "StripELL",
           "StripPart", "SlabELL", "SlabPack"]
