"""The least time an H100 could take for the committed steps of restarted
GMRES with classical Gram–Schmidt: the yardstick of
``kernel.gmres_step_roofline``.

Bytes only, over the data sheet's 3.35 TB/s (``roofline.HBM_BYTES_PER_S``).
A step j applies the operator once (``roofline.product_bytes``: its values,
x and y, which a SpMV moves at 40 or more times the rate its operations
allow, so the product's bound is its bytes), reads basis rows 0..j twice
(once for the projections h = V·w, once for the update w − Vᵀ·h) and
writes the new row once.  Only work that the algorithm defines is counted,
whatever implements the step: not the rows past j that a masked product
reads, not the preconditioner, the norms or the rotations.
"""

import roofline


def floor_s(committed, product_s, arnoldi_rows, arnoldi_bytes):
    """Seconds of ``committed`` steps: each one product of ``product_s``
    (the roofline bound of one SpMV), and the basis rows that their
    Gram–Schmidt projects against (``arnoldi_rows`` of them, ``arnoldi_bytes``
    in all) read twice, and one new row a step written."""
    row_bytes = arnoldi_bytes / arnoldi_rows
    basis_bytes = 2 * arnoldi_bytes + committed * row_bytes
    return committed * product_s + basis_bytes / roofline.HBM_BYTES_PER_S
