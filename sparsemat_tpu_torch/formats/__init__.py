"""Frozen sparse formats: ``COO`` (assembly snapshot), ``CSR`` (canonical
compute), ``DIA`` (banded/stencil), ``StripELL`` (bounded-span scattered,
the FEM class) and ``RouteStream`` (globally scattered, the circuit class).
The other formats of the JAX package, and ``auto_format``, are not ported
yet."""

from .base import SparseFormat
from .coo import COO
from .csr import CSR
from .dia import DIA
from .route import RouteStream
from .strip import StripELL, StripPart

__all__ = ["SparseFormat", "COO", "CSR", "DIA", "RouteStream", "StripELL", "StripPart"]
