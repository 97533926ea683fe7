"""What decides ``correct`` in ``circuit_scircuit.bicgstab`` fails what it
must, at 3,000 rows on the CPU.  The format is named ``route`` there: on the
CPU ``auto_format`` takes the JAX package's order off the TPU and would not
freeze this operator to the RouteStream that the card's ``auto_format``
picks.  The sound program passes; the controls (the plain reference and the
program's own path, both in bfloat16), the planted faults of
``test_portbench_faults.py`` and a solve stopped at rtol 1e-3, two decades
short, are not correct.  The operator is one matrix whatever the run's seed,
and the frozen generator is ``matgen.circuit_scatter`` scaled."""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import harness
from reference.system import ReferenceSystem
from system import LoweredPortSystem, PortSystem
from test_portbench_faults import Altered, HalfLeftOut, Unchanged
from test_portbench_imports import _env

CELL = "circuit_scircuit.bicgstab"
SMALL = {"n": 3000, "format": "route"}
#: a shorter cap bounds the controls' bfloat16 solves here
TRAFFIC = {"maxiter": 3000}


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch's CPU ops on one thread: the solves are thousands of small
    ops, which threads spinning in parallel test workers slow many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(system, traffic=None):
    return harness.run(CELL, 2**31 + 101, 0, 0, device="cpu", t_process=time.perf_counter(),
                       system=system, overrides=SMALL,
                       traffic_overrides=dict(TRAFFIC, **(traffic or {})),
                       count=int(harness.Cell(CELL).traffic["sample"]))


def test_operator_is_one_matrix_and_the_seed_draws_the_inputs():
    cell = harness.Cell(CELL, overrides=SMALL)
    a, b = cell.triplets(2**31 + 101), cell.triplets(7)
    assert a[3] == b[3] == (3000, 3000)
    assert all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert not torch.equal(cell.pool(2**31 + 101, 3000, "cpu"), cell.pool(7, 3000, "cpu"))


@pytest.mark.parametrize("matrix_seed", [0, 2**31 + 3])
def test_frozen_generator_is_matgen_scaled(matrix_seed):
    from sparsemat_tpu_torch import matgen

    cell = harness.Cell(CELL, overrides=dict(SMALL, matrix_seed=matrix_seed))
    rows, cols, vals, shape = cell.triplets(1)
    m = (matgen.circuit_scatter(3000, seed=matrix_seed) * np.float32(2e-2)).tocsr()
    m.sort_indices()
    m = m.tocoo()
    assert shape == m.shape
    assert np.array_equal(rows, m.row) and np.array_equal(cols, m.col)
    assert np.array_equal(vals, m.data.astype(np.float32))


def test_sound_program_is_correct():
    result, checks = run(PortSystem("cpu"))
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] == 12


@pytest.mark.parametrize("system", [lambda: ReferenceSystem("cpu", torch.bfloat16),
                                    lambda: LoweredPortSystem("cpu", torch.bfloat16)],
                         ids=["reference_bf16", "program_bf16"])
def test_control_is_not_correct(system):
    result, checks = run(system())
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", [Unchanged, HalfLeftOut, Altered], ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    result, checks = run(fault("cpu"))
    assert not result["correct"], checks


def test_solve_stopped_short_is_not_correct():
    result, checks = run(PortSystem("cpu"), {"rtol": 1e-3})
    assert not result["correct"], checks


def test_reference_f32_in_place_of_the_program_is_correct():
    """The plain BiCGStab in the configuration's own precision passes: the
    limits separate precisions, not implementations."""
    result, checks = run(ReferenceSystem("cpu", torch.float32))
    assert result["correct"], checks


#: each configuration's small size on the CPU, the new one included
SIZES = {"poisson2d_4m": {"grid": 16}, "fem_pwtk": {"n_nodes": 200, "bandwidth": 20},
         "circuit_scircuit": SMALL}

PROBE = r"""
import glob, os, sys, time
sys.path[:0] = [{bench!r}, {root!r}]
import harness, roofline, devtrace, card, system, calibrate, run
import reference.operator, reference.cg, reference.bicgstab, reference.system
for d in ("metrics", "configs"):
    for p in sorted(glob.glob(os.path.join({bench!r}, d, "*.py"))):
        harness.load_module(p)
for w in harness.load_json(os.path.join({root!r}, "BENCHMARK.json"))["workloads"]:
    harness.run(w["name"], 3, 0.05, 0, device="cpu", t_process=time.perf_counter(),
                overrides={sizes!r}[w["config"]], count=2)
print("FORBIDDEN", harness.forbidden_modules())
print("PORT", "sparsemat_tpu_torch" in sys.modules)
"""


def test_a_run_of_every_cell_loads_no_forbidden_module():
    """``test_portbench_imports.py``'s guard over every cell, with the new
    configuration sized: that file's table of sizes lacks it."""
    code = PROBE.format(bench=harness.HERE, root=harness.ROOT, sizes=SIZES)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=_env(), cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "PORT True" in out.stdout
