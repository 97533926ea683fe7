"""The least time an H100 could take for a sparse product, from the cell's
own inputs: the yardstick of every ``*_roofline`` metric.

The bound is the larger of two times:

* bytes over the data sheet's 3.35 TB/s: each stored value read once (its
  ``value_bytes``), x (or B, m columns) read once, y (or Y) written once;
* operations over the data sheet's 67 TFLOP/s (f32 outside the tensor
  cores): 2 · nnz · m.

Index bytes are left out on purpose: a layout may compress its indices
(the row-group plan already reads fewer than a CSR's), so only the values,
x and y form a floor that no layout or kernel can pass.  Both peaks are the
H100 SXM data sheet's at 700 W; the harness prints the card's power limit
beside them.
"""

#: the H100 SXM's published device-memory rate (bytes/s)
HBM_BYTES_PER_S = 3.35e12
#: the H100 SXM's published f32 rate outside the tensor cores (FLOP/s)
F32_FLOP_PER_S = 67e12


def product_bytes(nnz, n_rows, n_cols, m=1, value_bytes=4):
    """Bytes a product Y = A·B (B of m columns) has to move at least."""
    return (nnz + (n_rows + n_cols) * m) * value_bytes


def product_flops(nnz, m=1):
    """Operations of a product: one multiply and one add a stored entry and
    column."""
    return 2 * nnz * m


def bound_s(n_bytes, flops):
    """(seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def product_bound_s(nnz, n_rows, n_cols, m=1, value_bytes=4):
    """(seconds, what bounds it) of one product."""
    return bound_s(product_bytes(nnz, n_rows, n_cols, m, value_bytes),
                   product_flops(nnz, m))


def share_pct(bound, device_s_per_call):
    """The bound as a percentage of the measured device time per call; None
    where nothing was measured."""
    if not device_s_per_call or device_s_per_call <= 0:
        return None
    return 100.0 * bound / device_s_per_call
