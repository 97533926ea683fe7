"""The reference put in the program's place: the same calls as
``system.PortSystem``, computed in plain PyTorch in ``dtype``.  In a lower
precision than the configuration states it is the control, which the
judge has to find not correct."""

import importlib

import torch

from .operator import TripletOperator


class ReferenceSystem:
    def __init__(self, device, dtype=torch.bfloat16):
        self.device = torch.device(device)
        self.dtype = dtype

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def assemble(self, rows, cols, vals, shape, dtype):
        return TripletOperator(rows, cols, vals, shape, dtype=self.dtype, device=self.device)

    def freeze(self, csr, fmt):
        return csr

    def describe(self, A):
        return f"reference triplets in {self.dtype}"

    def preconditioner(self, csr, kind):
        if kind is None:
            return None
        if kind != "jacobi":
            raise ValueError(f"unknown preconditioner {kind!r}")
        d = csr.diagonal()
        return torch.where(d != 0, 1.0 / d, torch.zeros_like(d))

    def solve(self, A, b, M, traffic, maxiter=None):
        """The solver that the traffic names: ``reference/<name>.py``'s
        function of that name."""
        name = traffic["solver"]
        solver = getattr(importlib.import_module("." + name, __package__), name)
        return solver(A, b, tol=traffic["tol"], rtol=traffic["rtol"],
                  maxiter=traffic["maxiter"] if maxiter is None else maxiter, dinv=M)

    def product(self, A, X):
        return A.matmul(X)

    def matvec_dot(self, A, p):
        y = A.matmul(p)
        return y, torch.dot(p.to(y.dtype), y)
