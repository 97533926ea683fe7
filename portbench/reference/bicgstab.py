"""Plain BiCGStab (van der Vorst 1992; Saad, *Iterative Methods for Sparse
Linear Systems*, 2nd ed., Alg. 7.7), right-preconditioned, in the dtype of
its operator: the control that stands in the program's place in a lower
precision."""

import torch


def bicgstab(op, b, *, tol, rtol, maxiter, dinv=None):
    """x with ‖r‖ < max(tol, rtol·‖b‖) by the recursive residual, x0 = 0,
    the shadow residual r̂ = r0 = b; ``dinv`` the Jacobi preconditioner's
    1/diag, applied on the right (A·M·u = b, x = M·u).  Returns (x,
    iterations, converged)."""
    dt = op.dtype
    b = b.to(dt)

    def precond(v):
        return dinv * v if dinv is not None else v

    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r.clone()
    p = r.clone()
    rho = torch.dot(rhat, r)
    rr = float(torch.dot(r, r))
    bnorm = torch.linalg.vector_norm(b.to(torch.promote_types(dt, torch.float32)))
    thresh2 = max(tol, rtol * float(bnorm)) ** 2
    k = 0
    while k < maxiter and rr >= thresh2:
        phat = precond(p)
        v = op.matmul(phat)
        alpha = rho / torch.dot(rhat, v)
        s = r - alpha * v
        shat = precond(s)
        t = op.matmul(shat)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        rho = rho_new
        rr = float(torch.dot(r, r))
        k += 1
    return x, k, rr < thresh2
