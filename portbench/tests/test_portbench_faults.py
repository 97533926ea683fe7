"""What decides ``correct`` fails what it must, at a size a test run holds,
on the CPU (the harness's look for a card skipped, the rest of a run
driven): the control (the plain reference in bfloat16, one precision below
the configuration's float32, put in the program's place) and the faults a
cell can have, each planted in the program's answers where they are
produced.  The sound program passes."""

import time

import pytest
import torch

import harness
from reference.system import ReferenceSystem
from system import LoweredPortSystem, PortSystem

SMALL = {"poisson2d_4m": {"grid": 48}, "fem_pwtk": {"n_nodes": 600, "bandwidth": 40}}
#: a shorter cap keeps the control's unconverged bf16 solves short here
TRAFFIC = {"solve": {"maxiter": 3000}}
CELLS = ["poisson2d_4m.cg", "fem_pwtk.spmm128", "poisson2d_4m.spmv"]


class Unchanged(PortSystem):
    """A step that returns its state unchanged: the solve hands back x0 = 0,
    the product hands back its operand."""

    def solve(self, A, b, M, traffic, maxiter=None):
        _, it, ok = super().solve(A, b, M, traffic, maxiter)
        return torch.zeros_like(b), it, ok

    def product(self, A, X):
        y = super().product(A, X)
        return X.clone() if X.shape == y.shape else torch.zeros_like(y)


class HalfLeftOut(PortSystem):
    """Half of the batch left out: the second half of each answer's rows
    never computed (zero)."""

    def solve(self, A, b, M, traffic, maxiter=None):
        x, it, ok = super().solve(A, b, M, traffic, maxiter)
        x = x.clone()
        x[x.shape[0] // 2:] = 0
        return x, it, ok

    def product(self, A, X):
        y = super().product(A, X).clone()
        y[y.shape[0] // 2:] = 0
        return y


class Altered(PortSystem):
    """An answer altered where it is produced: one entry of each answer
    moved by the answer's own largest magnitude (a solve), or the largest
    entry of a product off by 1%."""

    def solve(self, A, b, M, traffic, maxiter=None):
        x, it, ok = super().solve(A, b, M, traffic, maxiter)
        x = x.clone()
        x[x.shape[0] // 3] += x.abs().max()
        return x, it, ok

    def product(self, A, X):
        y = super().product(A, X).clone()
        y.view(-1)[y.abs().argmax()] *= 1.01
        return y


class StoppedShort(PortSystem):
    """A solve stopped two decades short: rtol 1e-2 in place of the
    traffic's 1e-5, its SolveInfo still saying converged."""

    def solve(self, A, b, M, traffic, maxiter=None):
        return super().solve(A, b, M, dict(traffic, rtol=1e-2), maxiter)


def run(cell, system, overrides=None):
    seed = 2**31 + 101
    traffic = harness.Cell(cell).workload["traffic"]
    return harness.run(cell, seed, 0, 0, device="cpu", t_process=time.perf_counter(),
                       system=system, overrides=dict(SMALL[cell.split(".")[0]], **(overrides or {})),
                       traffic_overrides=TRAFFIC.get(traffic),
                       count=int(harness.Cell(cell).traffic["sample"]))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    result, checks = run(cell, PortSystem("cpu"))
    assert result["correct"], checks
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    result, checks = run(cell, ReferenceSystem("cpu", torch.bfloat16))
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", ["fem_pwtk.spmm128", "poisson2d_4m.spmv"])
def test_programs_own_bf16_path_is_not_correct(cell):
    """The program's own bfloat16 path (the operator's values cast with
    ``astype``, the inputs cast) is a control too where it computes in a
    lower precision: the FEM operator's values round, and a product's x
    does.  (On the Poisson solve it is not: the stencil is exact in
    bfloat16 and cg promotes to float32 from its first step, so only b is
    rounded; see PERF.md.)"""
    result, checks = run(cell, LoweredPortSystem("cpu", torch.bfloat16))
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", [Unchanged, HalfLeftOut, Altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    result, checks = run(cell, fault("cpu"))
    assert not result["correct"], checks


def test_solve_stopped_short_is_not_correct():
    """The residual's limit sits below what a solve stopped at rtol 1e-2
    reads (just under 1e-2), not only below the control's."""
    result, checks = run("poisson2d_4m.cg", StoppedShort("cpu"))
    assert not result["correct"], checks


@pytest.mark.parametrize("preconditioner", [None, "jacobi"])
def test_reference_f32_in_place_of_the_program_is_correct(preconditioner):
    """The reference in the configuration's own precision passes, with and
    without the preconditioner a configuration may name: the limits
    separate precisions, not implementations."""
    result, checks = run("poisson2d_4m.cg", ReferenceSystem("cpu", torch.float32),
                         {"preconditioner": preconditioner})
    assert result["correct"], checks


@pytest.mark.parametrize("system", [PortSystem, lambda d: ReferenceSystem(d, torch.bfloat16)],
                         ids=["program", "control"])
def test_preconditioned_solve_is_judged(system):
    """A configuration that names the Jacobi preconditioner drives it on
    both sides: the program's PCG passes, the control's fails."""
    result, checks = run("poisson2d_4m.cg", system("cpu"), {"preconditioner": "jacobi"})
    assert result["correct"] == (system is PortSystem), checks
