"""Frozen sparse formats (counterpart of ``sparsemat_tpu/formats``):
``COO`` (assembly snapshot), ``CSR`` (canonical compute), ``DIA``
(banded/stencil), ``ELL`` (rows padded to one length), ``SELL`` (sliced ELL
for skewed rows), ``BSR`` (dense blocks, the SpMM format), ``StripELL``
(bounded-span scattered, the FEM class), ``SlabELL``, ``SlabPack`` and
``SlabStream`` (window-bucketed slabs for the same class), ``WELL``
(windowed ELL, the general-matrix format), ``RouteStream`` (globally
scattered, the circuit class) and ``GELL`` (the scatter-free gather ladder);
``auto_format``, which picks among them; and ``RowVec``, the host-side
ragged assembly format that freezes to CSR or COO."""

import numpy as np

from ..utils import profiling
from .base import SparseFormat
from .bsr import BSR
from .coo import COO
from .csr import CSR
from .dia import DIA
from .ell import ELL
from .gell import GELL
from .route import RouteStream
from .rowvec import RowVec
from .sell import SELL
from .slab import SLAB_ROW_BLOCK, SUBLANE, WINDOW, SlabELL, SlabPack, SlabStream
from .strip import StripELL, StripPart
from .well import WELL

__all__ = ["SparseFormat", "COO", "CSR", "DIA", "ELL", "SELL", "BSR", "GELL", "RouteStream",
           "StripELL", "StripPart", "SlabELL", "SlabPack", "SlabStream", "WELL", "RowVec",
           "auto_format"]


def auto_format(mat, *, max_diags: int = 48, max_ell_waste: float = 2.0,
                max_slab_waste: float = 24.0):
    """The compute format for a frozen matrix, chosen on the host by the
    matrix's device.

    * A CPU matrix takes the JAX package's order off the TPU, unchanged:
      few distinct diagonals → DIA; a tight entries-per-row spread (ELL
      padding within ``max_ell_waste``×) → ELL; SELL within the same waste;
      bounded-span rows → StripELL, then SlabPack (within
      ``max_slab_waste``× padding, its operand windows within 8 MB); else
      GELL.
    * A CUDA matrix takes the JAX package's TPU order, because the port has
      that order's kernels: DIA → ELL → StripELL → SlabPack → RouteStream.
      SELL is skipped (it has no kernel), and the TPU's VMEM and SMEM
      guards (SlabPack's 8 MB operand windows, RouteStream's 12 MB staging
      estimate, its residency and its 768 KB of prefetch tables) are not
      kept.  The RouteStream freeze takes every matrix, so on the card GELL
      is not reached.

    Both orders bound SlabPack's freeze cost before it runs: each distinct
    (256-row block, 128-column window) bucket costs at least 8 × 256 slots,
    and a globally scattered operand whose lower bound already breaks the
    waste cap is never frozen (on the scircuit-class surrogate the JAX
    package once built a 13 GB layout that way).  Recorded as the set-up
    span ``freeze.auto_format``."""
    with profiling.span("freeze.auto_format", setup=True):
        return _auto_format(mat, max_diags, max_ell_waste, max_slab_waste)


def _auto_format(mat, max_diags, max_ell_waste, max_slab_waste):
    csr = mat.to_csr()
    nnz = csr.n_non_zero_entries()
    if nnz == 0:
        return csr
    if DIA.diagonal_count(csr) <= max_diags:
        return DIA.from_csr(csr)
    n_rows = csr.shape[0]
    if csr.max_row_nnz() * n_rows <= max_ell_waste * nnz:
        return ELL.from_csr(csr)
    on_card = csr.device.type == "cuda"
    if not on_card:
        sell = SELL.from_csr(csr, slice_height=8)
        if sell.nse <= max_ell_waste * nnz:
            return sell
    try:
        strip = StripELL.from_csr(csr)
        if strip.nse <= max_slab_waste * nnz:
            return strip
    except ValueError:          # a 128-row block's span exceeds the strip reach
        pass
    indptr = csr.host("indptr").astype(np.int64)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
    wins = csr.host("indices")[:nnz].astype(np.int64) // WINDOW
    n_win = max(-(-csr.shape[1] // WINDOW), 1)
    pairs = np.unique((rows // SLAB_ROW_BLOCK) * n_win + wins).size
    if pairs * SUBLANE * SLAB_ROW_BLOCK <= max_slab_waste * nnz:
        slab = SlabPack.from_csr(csr)
        if (slab.nse <= max_slab_waste * nnz
                and (on_card or slab.x_bytes() <= 8 * 1024 * 1024)):
            return slab
    if on_card:
        return RouteStream.from_csr(csr)
    return GELL.from_csr(csr)
