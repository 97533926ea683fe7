"""Plain (preconditioned) conjugate gradients, in the dtype of its operator:
the control that stands in the program's place in a lower precision."""

import torch


def cg(op, b, *, tol, rtol, maxiter, dinv=None):
    """x with ‖r‖ < max(tol, rtol·‖b‖) by the recursive residual, x0 = 0;
    ``dinv`` the Jacobi preconditioner's 1/diag.  Returns (x, iterations,
    converged)."""
    dt = op.dtype
    b = b.to(dt)
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r if dinv is not None else r
    p = z.clone()
    rz = torch.dot(r, z)
    rr = float(torch.dot(r, r))
    thresh2 = max(tol, rtol * float(torch.linalg.vector_norm(b.float()))) ** 2
    k = 0
    while k < maxiter and rr >= thresh2:
        Ap = op.matmul(p)
        pAp = torch.dot(p, Ap)
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r if dinv is not None else r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rr = float(torch.dot(r, r))
        k += 1
    return x, k, rr < thresh2
