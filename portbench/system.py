"""The system under test, sparsemat_tpu_torch, through its public entry
points: ``SparseBuilder`` → ``to_csr(device)`` → ``auto_format`` →
``solvers.cg`` (with ``JacobiPreconditioner``), ``spmv``, ``spmv_dot``,
``spmm``; the solver is the one the traffic names.  The only module of the harness that imports the program."""

import torch


class PortSystem:
    def __init__(self, device):
        import sparsemat_tpu_torch as tsm
        from sparsemat_tpu_torch import solvers

        self.tsm, self.solvers = tsm, solvers
        self.device = torch.device(device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def assemble(self, rows, cols, vals, shape, dtype):
        """Host assembly and freeze to CSR on the device."""
        b = self.tsm.SparseBuilder(rows.size, dtype=dtype)
        b.add_batch(rows, cols, vals)
        return b.to_csr(device=self.device)

    def freeze(self, csr, fmt):
        """The compute format: ``auto_format``'s pick, or a named one."""
        return self.tsm.auto_format(csr) if fmt == "auto_format" else getattr(csr, f"to_{fmt}")()

    def describe(self, A):
        return type(A).__name__

    def preconditioner(self, csr, kind):
        if kind is None:
            return None
        if kind != "jacobi":
            raise ValueError(f"unknown preconditioner {kind!r}")
        return self.solvers.JacobiPreconditioner.from_matrix(csr)

    def solve(self, A, b, M, traffic, maxiter=None):
        """One solve by the solver that the traffic names (``solvers.<name>``);
        it ends when the host reads its SolveInfo.  Returns (x, iterations,
        converged)."""
        x, info = getattr(self.solvers, traffic["solver"])(
            A, b, tol=traffic["tol"], rtol=traffic["rtol"],
            maxiter=traffic["maxiter"] if maxiter is None else maxiter, M=M)
        return x, int(info.iterations), bool(info.converged)

    def product(self, A, X):
        return self.tsm.spmv(A, X) if X.dim() == 1 else self.tsm.spmm(A, X)

    def matvec_dot(self, A, p):
        """The op ``cg`` applies each iteration: (A·p, pᵀA·p)."""
        return self.tsm.spmv_dot(A, p)


class LoweredPortSystem(PortSystem):
    """The program's own lower-precision path, a control: the frozen
    operator's values cast with ``astype`` (the mixed-precision solvers'
    low-precision operator) and each input cast to ``dtype`` before the
    call."""

    def __init__(self, device, dtype=torch.bfloat16):
        super().__init__(device)
        self.dtype = dtype

    def freeze(self, csr, fmt):
        return super().freeze(csr, fmt).astype(self.dtype)

    def describe(self, A):
        return f"{type(A).__name__} as {self.dtype}"

    def preconditioner(self, csr, kind):
        return super().preconditioner(csr.astype(self.dtype), kind)

    def solve(self, A, b, M, traffic, maxiter=None):
        return super().solve(A, b.to(self.dtype), M, traffic, maxiter)

    def product(self, A, X):
        return super().product(A, X.to(self.dtype))

    def matvec_dot(self, A, p):
        return super().matvec_dot(A, p.to(self.dtype))
