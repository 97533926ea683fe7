"""The harness takes what a cell is from its files: the value dtype from the
configuration (the operator, the inputs and the roofline's bytes a value)
and the solver from the traffic mix, looked up by name in the program and
in the reference alike."""

import sys
import time
import types

import numpy as np
import pytest
import torch

import harness
import roofline
from reference import cg as reference_cg
from reference.system import ReferenceSystem
from system import PortSystem

SMALL = {"poisson2d_4m.cg": {"grid": 16}, "fem_pwtk.spmm128": {"n_nodes": 200, "bandwidth": 20}}


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dtype_of_the_configuration_reaches_operator_inputs_and_bound(cell, dtype):
    c = harness.Cell(cell, overrides=dict(SMALL[cell], dtype=dtype))
    rows, cols, vals, shape = c.triplets(2**31 + 5)
    assert vals.dtype == np.dtype(dtype)
    assert c.pool(3, shape[0], "cpu").dtype == getattr(torch, dtype)
    system = PortSystem("cpu")
    A = system.freeze(system.assemble(rows, cols, vals, shape, c.dtype), c.config["format"])
    assert system.product(A, c.pool(3, shape[0], "cpu")[0]).dtype == getattr(torch, dtype)
    value_bytes = 8 if dtype == "float64" else 4
    m = int(c.traffic.get("columns", 1))
    expect = (vals.size + 2 * shape[0] * m) * value_bytes / roofline.HBM_BYTES_PER_S
    assert c.bound_s(vals.size, shape) == pytest.approx(
        max(expect, 2 * vals.size * m / roofline.F32_FLOP_PER_S))


def test_float64_configuration_runs_and_is_judged():
    result, checks = harness.run("poisson2d_4m.cg", 11, 0, 0, device="cpu",
                                 t_process=time.perf_counter(),
                                 overrides={"grid": 16, "dtype": "float64"}, count=3)
    assert result["correct"], checks


def test_solver_is_looked_up_by_the_traffics_name(monkeypatch):
    """A traffic naming ``my_solver`` runs ``solvers.my_solver`` in the
    program and ``reference/my_solver.py``'s ``my_solver`` in the
    reference, and nothing else."""
    from sparsemat_tpu_torch import solvers

    calls = []

    def program_solver(*a, **kw):
        calls.append("program")
        return solvers.cg(*a, **kw)

    def reference_solver(*a, **kw):
        calls.append("reference")
        return reference_cg.cg(*a, **kw)

    monkeypatch.setattr(solvers, "my_solver", program_solver, raising=False)
    module = types.ModuleType("reference.my_solver")
    module.my_solver = reference_solver
    monkeypatch.setitem(sys.modules, "reference.my_solver", module)
    for system in (PortSystem("cpu"), ReferenceSystem("cpu", torch.float32)):
        result, checks = harness.run("poisson2d_4m.cg", 11, 0, 0, device="cpu",
                                     t_process=time.perf_counter(), system=system,
                                     overrides={"grid": 16},
                                     traffic_overrides={"solver": "my_solver", "warm_ops": 1},
                                     count=2)
        assert result["correct"], checks
    assert calls == ["program"] * 3 + ["reference"] * 3
