"""An operator rebuilt from triplets, its products in plain PyTorch, and the
two numbers that judge the program's answers."""

import torch

#: entries × columns of one block of the blocked product (f64: 512 MB)
BLOCK = 1 << 26


class TripletOperator:
    """A sparse operator held as coalesced (rows, cols, vals): duplicate
    coordinates summed, as ``SparseBuilder.add_batch`` sums them."""

    def __init__(self, rows, cols, vals, shape, dtype=torch.float64, device="cpu"):
        n_rows, n_cols = (int(s) for s in shape)
        r = torch.as_tensor(rows, dtype=torch.int64).to(device)
        c = torch.as_tensor(cols, dtype=torch.int64).to(device)
        v = torch.as_tensor(vals).to(device=device, dtype=dtype)
        keys, inverse = torch.unique(r * n_cols + c, return_inverse=True)
        self.vals = torch.zeros(keys.numel(), dtype=dtype, device=device).index_add_(
            0, inverse, v)
        self.rows = keys // n_cols
        self.cols = keys % n_cols
        self.shape = (n_rows, n_cols)
        self.dtype = dtype

    @property
    def nnz(self):
        return int(self.vals.numel())

    def matmul(self, X, absolute=False):
        """A·X (or |A|·|X|) for X of shape (n_cols,) or (n_cols, m), in
        this operator's dtype, in blocks of entries."""
        X = X.to(self.dtype)
        vec = X.dim() == 1
        X2 = X[:, None] if vec else X
        if absolute:
            X2 = X2.abs()
        m = X2.shape[1]
        Y = torch.zeros((self.shape[0], m), dtype=self.dtype, device=X2.device)
        step = max(1, BLOCK // m)
        for s in range(0, self.nnz, step):
            v = self.vals[s:s + step]
            if absolute:
                v = v.abs()
            Y.index_add_(0, self.rows[s:s + step], v[:, None] * X2[self.cols[s:s + step]])
        return Y[:, 0] if vec else Y

    def diagonal(self):
        d = torch.zeros(min(self.shape), dtype=self.dtype, device=self.vals.device)
        on = self.rows == self.cols
        return d.index_add_(0, self.rows[on], self.vals[on])


def relative_residual(op, x, b):
    """‖b − A·x‖₂ / ‖b‖₂ in f64 (``op`` an f64 operator); NaN reads inf."""
    b = b.to(torch.float64)
    r = b - op.matmul(x.to(torch.float64))
    rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    return rel if rel == rel else float("inf")


def row_error(op, Y, X):
    """max over (i, j) of |Y − A·X|_ij / (|A|·|X|)_ij in f64: each answer's
    error against what rounding the terms it sums could give.  A zero
    denominator reads as the smallest normal number, so any error there is
    huge; NaN reads inf."""
    ref = op.matmul(X)
    scale = op.matmul(X, absolute=True).clamp_min(torch.finfo(torch.float64).tiny)
    err = (Y.to(torch.float64) - ref).abs() / scale
    err = torch.nan_to_num(err, nan=float("inf"))
    return float(err.max()) if err.numel() else 0.0
