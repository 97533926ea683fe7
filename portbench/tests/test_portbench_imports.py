"""No module the harness loads is JAX's or the JAX package's, compared by
top-level name (before the first dot, whole): ``sparsemat_tpu_torch``
passes, ``sparsemat_tpu`` does not.  And the command refuses to run
without a card, or without the program beside it."""

import os
import shutil
import subprocess
import sys

import harness

PROBE = r"""
import glob, os, sys, time
sys.path[:0] = [{bench!r}, {root!r}]
import harness, roofline, devtrace, card, system, calibrate, run
import reference.operator, reference.cg, reference.system
for d in ("metrics", "configs"):
    for p in sorted(glob.glob(os.path.join({bench!r}, d, "*.py"))):
        harness.load_module(p)
# drive the port through one small run of every cell, on the CPU
ov = {{"poisson2d_4m": {{"grid": 16}}, "fem_pwtk": {{"n_nodes": 200, "bandwidth": 20}}}}
for w in harness.load_json(os.path.join({root!r}, "BENCHMARK.json"))["workloads"]:
    harness.run(w["name"], 3, 0.05, 0, device="cpu", t_process=time.perf_counter(),
                overrides=ov[w["config"]], count=2)
print("FORBIDDEN", harness.forbidden_modules())
print("PORT", "sparsemat_tpu_torch" in sys.modules)
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_no_forbidden_module_after_every_harness_module():
    code = PROBE.format(bench=harness.HERE, root=harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=_env(), cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
    assert "PORT True" in out.stdout


def test_forbidden_is_by_whole_top_level_name():
    saved = set(sys.modules)
    try:
        for name in ("sparsemat_tpu_torch_fake.x", "jaxtyping", "sparsemat_tpu_x"):
            sys.modules.setdefault(name, object())
        found = harness.forbidden_modules()
        assert not {"sparsemat_tpu_torch_fake.x", "jaxtyping", "sparsemat_tpu_x"} & set(found)
        sys.modules["sparsemat_tpu.kernels"] = object()
        assert "sparsemat_tpu.kernels" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - saved:
            del sys.modules[k]


def test_run_exits_nonzero_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "poisson2d_4m.cg",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=_env(),
                         cwd=harness.ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "no CUDA card" in out.stderr


def test_benchmark_alone_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path[:0] = ['portbench', '.']; import harness; "
            "harness.run('poisson2d_4m.spmv', 1, 0.05, 0, device='cpu', "
            "t_process=time.perf_counter(), overrides={'grid': 8}, count=1)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=_env(), cwd=tmp_path)
    assert out.returncode != 0
    assert "sparsemat_tpu_torch" in out.stderr
