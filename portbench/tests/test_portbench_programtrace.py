"""The readers of the program's own spans and counters (``programtrace.py``
and the six ``program_span`` / ``program_counter`` metrics): each number
from a made-up record, and None where the program keeps none (not loaded,
or a version without ``trace_record``) or the record lacks the reader's
numbers."""

import os
import sys
import types

import pytest

import harness
import programtrace

RECORD = {
    "spans": {
        "solver.block": {"count": 130, "total_s": 3.12, "self_s": 3.12},
        "ops.spmv": {"count": 2000, "total_s": 0.07, "self_s": 0.07},
        "ops.spmm": {"count": 20, "total_s": 1.5, "self_s": 1.5},
        "freeze.auto_format": {"count": 1, "total_s": 1.25, "self_s": 1.25},
        "freeze.plan": {"count": 2, "total_s": 9.0, "self_s": 0.03},
        "freeze.build": {"count": 1, "total_s": 8.97, "self_s": 8.97},
    },
    "counters": {
        "solver": {"steps_executed": 4160, "steps_committed": 4139},
        "ops.conversions": {"csr": 20, "ell": 0},
        "kernels.dia": {"dia_spmv": 0, "dia_spmv_dot": 0, "dia_spmv_chain": 0},
    },
}
SOLVE = {"kind": "solve", "columns": 1}
SPMV = {"kind": "product", "columns": 1}
SPMM = {"kind": "product", "columns": 128}
EXPECTED = {
    "solver.step_yield": (SOLVE, 100.0 * 4139 / 4160),
    "solver.host_us_per_step": (SOLVE, 1e6 * 3.12 / 4160),
    "dispatch.host_us_per_call": (SPMV, 1e6 * 0.07 / 2000),
    "dispatch.conversions_per_call": (SPMM, 1.0),
    "freeze.format_s": (SPMM, 1.25),
    "freeze.plan_s": (SPMV, 0.03),
}


def reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics", name + ".py"))


@pytest.fixture
def program(monkeypatch):
    """Stand a made-up program's profiling module in the real one's place."""
    def put(record):
        mod = types.ModuleType(programtrace.MODULE)
        if record is not None:
            mod.trace_record = lambda: record
        monkeypatch.setitem(sys.modules, programtrace.MODULE, mod)
    return put


@pytest.mark.parametrize("name", list(EXPECTED))
def test_reader_reads_the_record(program, name):
    run, value = EXPECTED[name]
    program(RECORD)
    assert reader(name).read(run) == pytest.approx(value)


@pytest.mark.parametrize("name", list(EXPECTED))
def test_reader_is_none_without_a_record(program, monkeypatch, name):
    run, _ = EXPECTED[name]
    monkeypatch.delitem(sys.modules, programtrace.MODULE, raising=False)
    assert reader(name).read(run) is None
    program(None)                           # a program that keeps no record
    assert reader(name).read(run) is None
    program({"spans": {}, "counters": {}})
    assert reader(name).read(run) is None


@pytest.mark.parametrize("name,run", [("solver.step_yield", SPMV),
                                      ("solver.host_us_per_step", SPMM),
                                      ("dispatch.host_us_per_call", SOLVE),
                                      ("dispatch.conversions_per_call", SPMV)])
def test_per_call_reader_is_none_in_another_kind_of_cell(program, name, run):
    program(RECORD)
    assert reader(name).read(run) is None


def test_no_steps_and_no_calls_read_none(program):
    program({"spans": {"solver.block": {"count": 0, "total_s": 0.0, "self_s": 0.0},
                       "ops.spmm": {"count": 0, "total_s": 0.0, "self_s": 0.0}},
             "counters": {"solver": {"steps_executed": 0, "steps_committed": 0},
                          "ops.conversions": {}}})
    for name, run in (("solver.step_yield", SOLVE), ("solver.host_us_per_step", SOLVE),
                      ("dispatch.conversions_per_call", SPMM)):
        assert reader(name).read(run) is None, name


def test_the_real_program_record_is_read():
    from sparsemat_tpu_torch.utils import profiling

    profiling.reset_trace()
    with profiling.tracing():
        with profiling.span("ops.spmv"):
            pass
    try:
        assert reader("dispatch.host_us_per_call").read(SPMV) > 0
    finally:
        profiling.reset_trace()
