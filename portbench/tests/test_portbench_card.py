"""One short run of the command on the card: the result's last line and the
checks on standard error.  Skips where torch finds no card."""

import json
import subprocess
import sys

import pytest
import torch

import harness


@pytest.mark.cuda
def test_short_run_prints_the_contract_line():
    if not torch.cuda.is_available():
        pytest.skip("torch finds no CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "poisson2d_4m.spmv",
                          "--seed", "2147483650", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert set(result["metrics"]) == {"spmv_us", "setup_s"}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check row_error")
