"""BiCGStab over the RouteStream on the circuit-class operator: the port's
``solvers.bicgstab`` over ``CSR.to_route()`` against a plain BiCGStab written
here and against scipy's direct solve, on ``matgen.circuit_scatter(n, seed)
* 2e-2`` at 3,000 rows, seeded.  A ``cuda``-marked case runs the comparison
at 20,000 rows through ``route_spmv_kernel`` in f32.

Tolerances.  The port and the plain solver run the same recurrences (van
der Vorst's BiCGStab, right-preconditioned) with products and dots summed in
other orders.  With Jacobi scaling they stay within 10⁻¹⁵ to convergence.
Unpreconditioned, the recurrence loses biorthogonality on this operator
(ρ = r̂·r falls eight decades in ~25 steps, the residual peaks), and a
rounding difference of 10⁻¹⁶ grows to 10⁻¹¹–10⁻⁷ by step 30 and 10⁻⁵ by
step 40 (seeds 0 and 2³¹ + 3; the port over RouteStream and over CSR part
as far): two sound implementations then take different step counts (48
and 49, 54 and 49 at rtol 1e-5).  So the step-for-step comparison runs 16
steps, where the two agree within 2·10⁻¹³, at 1e-9; and each converged
solve is held to scipy: its true residual under rtol, and x within 200·rtol
of ``spsolve``'s, since ‖x − x*‖/‖x*‖ ≤ κ₂·‖r‖/‖b‖ and κ₂ is 169–177 at
3,000 rows.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
import sparsemat_tpu_torch as tsm
from sparsemat_tpu_torch import matgen, solvers
from sparsemat_tpu_torch.kernels import _rowgroup as rg

N = 3000
SEEDS = [0, 2**31 + 3]
SCALE = 2e-2
#: steps that the port and the plain solver take in lockstep in f64 (see above)
STEPS = 16
RTOL = 1e-8
#: κ₂ of the operator at 3,000 rows is 169–177: the forward error's room
FORWARD = 200


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch's CPU ops on one thread: the solves are thousands of small
    ops, which threads spinning in parallel test workers slow many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class PlainOperator:
    """A·v from the CSR's entries by ``index_add_``, in the matrix's dtype."""

    def __init__(self, m, device="cpu"):
        coo = m.tocoo()
        self.rows = torch.from_numpy(coo.row.astype(np.int64)).to(device)
        self.cols = torch.from_numpy(coo.col.astype(np.int64)).to(device)
        self.vals = torch.from_numpy(coo.data).to(device)
        self.n = m.shape[0]

    def __call__(self, v):
        y = torch.zeros(self.n, dtype=self.vals.dtype, device=self.vals.device)
        return y.index_add_(0, self.rows, self.vals * v[self.cols])

    def diagonal(self):
        d = torch.zeros(self.n, dtype=self.vals.dtype, device=self.vals.device)
        on = self.rows == self.cols
        return d.index_add_(0, self.rows[on], self.vals[on])


def plain_bicgstab(A, b, *, rtol, maxiter, dinv=None):
    """Textbook BiCGStab (van der Vorst 1992; Saad, 2nd ed., Alg. 7.7), x0 =
    0, r̂ = r0 = b, right-preconditioned by ``dinv`` where given, stopped on
    the recursive residual: (x, iterations, converged)."""
    def precond(v):
        return dinv * v if dinv is not None else v

    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r.clone()
    p = r.clone()
    rho = torch.dot(rhat, r)
    rr = float(torch.dot(r, r))
    thresh2 = (rtol * float(torch.linalg.vector_norm(b))) ** 2
    k = 0
    while k < maxiter and rr >= thresh2:
        phat = precond(p)
        v = A(phat)
        alpha = rho / torch.dot(rhat, v)
        s = r - alpha * v
        shat = precond(s)
        t = A(shat)
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


def operator(seed, dtype=np.float64, n=N):
    m = (matgen.circuit_scatter(n, seed=seed) * SCALE).astype(dtype).tocsr()
    m.sort_indices()
    return m


def rhs(seed, n, dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g, dtype=dtype)


def both(m, b, M, *, rtol, maxiter, device="cpu"):
    """The port's bicgstab over the RouteStream and the plain one's, with
    Jacobi scaling where ``M``: (x, iterations, converged) each."""
    csr = tsm.CSR.from_scipy(m, device=device)
    A = csr.to_route()
    pre = solvers.JacobiPreconditioner.from_matrix(csr) if M == "jacobi" else None
    x, info = solvers.bicgstab(A, b, tol=0.0, rtol=rtol, maxiter=maxiter, M=pre)
    op = PlainOperator(m, device=device)
    dinv = 1.0 / op.diagonal() if M == "jacobi" else None
    ref = plain_bicgstab(op, b, rtol=rtol, maxiter=maxiter, dinv=dinv)
    return (x, int(info.iterations), bool(info.converged)), ref


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def true_residual(m, x, b):
    b = b.double().cpu().numpy()
    return np.linalg.norm(b - m.astype(np.float64) @ x.double().cpu().numpy()) / np.linalg.norm(b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("M", [None, "jacobi"])
def test_port_and_reference_take_the_same_steps(M, seed):
    """f64, stopped at rtol 1e-8 or after 16 steps: Jacobi-scaled solves
    converge within them (15–16 steps), unpreconditioned ones run all 16;
    equal step counts and flags, x within 1e-9."""
    m = operator(seed)
    b = rhs(seed, N, torch.float64)
    (x, k, ok), (xr, kr_, okr) = both(m, b, M, rtol=RTOL, maxiter=STEPS)
    assert (k, ok) == (kr_, okr)
    assert ok == (M == "jacobi")
    assert rel(x, xr) < 1e-9


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("M", [None, "jacobi"])
def test_port_and_reference_reach_rtol_against_spsolve(M, seed):
    m = operator(seed)
    b = rhs(seed, N, torch.float64)
    x_star = spla.spsolve(m.tocsc(), b.numpy())
    for x, k, ok in both(m, b, M, rtol=RTOL, maxiter=2000):
        assert ok and k < 2000
        assert true_residual(m, x, b) < RTOL
        assert rel(x, torch.from_numpy(x_star)) < FORWARD * RTOL


# -- on the card --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_cuda_route_kernel_solve_against_reference(cuda, seed):
    """20,000 rows in f32, the port's SpMVs one ``route_spmv_kernel``
    launch each.  f32 rounds at 6·10⁻⁸ a step and the unpreconditioned
    recurrence amplifies it (on the CPU: 2·10⁻⁷ after 8 steps, 10⁻⁵ after
    12), so the lockstep comparison runs 8 steps at 1e-5; converged solves
    (rtol 1e-5) are held to 2·rtol of true residual, since in f32 the
    recursive residual drifts from the true one (9.97·10⁻⁶ on the CPU)."""
    n = 20_000
    m = operator(seed, np.float32, n=n)
    b = rhs(seed, n, torch.float32).to(cuda)
    (x, k, _), (xr, _, _) = both(m, b, None, rtol=0.0, maxiter=8, device=cuda)
    assert k == 8 and rel(x, xr) < 1e-5
    rg.reset_launches()
    port, ref = both(m, b, None, rtol=1e-5, maxiter=2000, device=cuda)
    for x, k, ok in (ref, port):
        assert ok and true_residual(m, x, b) < 2e-5
    # the initial residual's SpMV, then two a step, counted as the host
    # enqueues them: over the first block, run op by op, and over the block
    # captured into the loop's CUDA graph (a replay enqueues none)
    blocks = -(-k // solvers.SYNC_EVERY)
    assert rg.LAUNCHES["route_spmv"] == 1 + 2 * solvers.SYNC_EVERY * min(blocks, 2)
