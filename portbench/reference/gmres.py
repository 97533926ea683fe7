"""Plain restarted GMRES(m) (Saad, *Iterative Methods for Sparse Linear
Systems*, 2nd ed., §6.5: Arnoldi by modified Gram–Schmidt, the Hessenberg
least-squares problem kept in QR form by Givens rotations; right
preconditioning as in §9.3.2), in the dtype of its operator: the control
that stands in the program's place in a lower precision.  The Hessenberg
entries, the rotations and the back substitution are host floats."""

import math

import torch


def gmres(op, b, *, tol, rtol, maxiter, dinv=None, restart=30):
    """x with ‖b − A·x‖ < max(tol, rtol·‖b‖), x0 = 0, the residual computed
    anew at each restart; a cycle ends early once the rotated residual
    estimate falls under that threshold, or on a breakdown.  ``dinv`` the
    Jacobi preconditioner's 1/diag, applied on the right (A·M·u = b, x =
    x0 + M·u).  Iterations count whole cycles × ``restart``, and the cycles
    run to ``maxiter`` rounded up to whole cycles.  Returns (x, iterations,
    converged)."""
    dt = op.dtype
    b = b.to(dt)
    m = int(restart)

    def precond(v):
        return dinv * v if dinv is not None else v

    def norm(v):
        return math.sqrt(float(torch.dot(v, v)))

    bnorm = torch.linalg.vector_norm(b.to(torch.promote_types(dt, torch.float32)))
    thresh = max(tol, rtol * float(bnorm))
    x = torch.zeros_like(b)
    res = norm(b)
    k, limit = 0, max(-(-int(maxiter) // m), 1) * m
    while k < limit and res >= thresh:
        r = b - op.matmul(x)
        beta = norm(r)
        V = [r / beta]
        H = [[0.0] * m for _ in range(m + 1)]
        cs, sn = [], []
        g = [beta] + [0.0] * m
        steps = 0
        for j in range(m):
            w = op.matmul(precond(V[j]))
            for i in range(j + 1):
                H[i][j] = float(torch.dot(w, V[i]))
                w = w - H[i][j] * V[i]
            h_next = norm(w)
            H[j + 1][j] = h_next
            for i in range(j):
                H[i][j], H[i + 1][j] = (cs[i] * H[i][j] + sn[i] * H[i + 1][j],
                                        -sn[i] * H[i][j] + cs[i] * H[i + 1][j])
            denom = math.hypot(H[j][j], H[j + 1][j])
            c, s = (H[j][j] / denom, H[j + 1][j] / denom) if denom > 0 else (1.0, 0.0)
            cs.append(c)
            sn.append(s)
            H[j][j], H[j + 1][j] = c * H[j][j] + s * H[j + 1][j], 0.0
            g[j], g[j + 1] = c * g[j], -s * g[j]
            steps = j + 1
            if abs(g[j + 1]) < thresh or h_next == 0:
                break
            V.append(w / h_next)
        y = [0.0] * steps
        for i in reversed(range(steps)):
            y[i] = (g[i] - sum(H[i][q] * y[q] for q in range(i + 1, steps))) / H[i][i]
        u = torch.zeros_like(b)
        for i in range(steps):
            u = u + y[i] * V[i]
        x = x + precond(u)
        res = norm(b - op.matmul(x))
        k += m
    return x, k, res < thresh
