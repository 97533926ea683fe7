"""The port's multi-host glue (``parallel/multihost.py``) in four real OS
processes on the CPU: two "hosts" of two ranks (``LOCAL_WORLD_SIZE=2``)
joined by ``init_distributed`` over gloo, the host-major row mesh, the
(hosts × chips) mesh, ``process_info``, and a distributed SpMV and CG on
the 2-D Poisson operator against scipy (the counterpart of
``tests/test_multiprocess.py``).  A hung rank is killed at the job's time
limit and fails the test.  On a machine with a card, a ``cuda`` test runs
the world of one rank under NCCL."""

import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from _torch_cpu import port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)
from sparsemat_tpu_torch import parallel
from sparsemat_tpu_torch.parallel import dist as pdist

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_mp_worker.py")
WORLD = 4


def test_four_process_two_host_distributed_cg(tmp_path):
    env = dict(os.environ, LOCAL_WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, _WORKER, str(rank), str(WORLD),
                               str(tmp_path / "store")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=dict(env, LOCAL_RANK=str(rank % 2)))
             for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert "MP_OK" in out, f"rank {rank} missing MP_OK:\n{out[-3000:]}"


def test_one_process_needs_no_process_group():
    parallel.init_distributed(num_processes=1)
    assert parallel.process_info()["process_count"] == (
        dist.get_world_size() if dist.is_initialized() else 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_world_of_one_under_nccl_launches_the_kernels(cuda):
    from sparsemat_tpu_torch.parallel.dryrun import dryrun_multichip

    started = not dist.is_initialized()
    try:
        pdist.reset_launches()
        line = dryrun_multichip(1, device=cuda)
        assert dist.get_backend() == "nccl"
        assert "bitwise-deterministic reruns OK" in line
        assert all(pdist.LAUNCHES[k] > 0 for k in ("dist_dia_spmv", "dist_csr_spmv",
                                                   "dist_slab_spmv", "dist_csr_subset_spmv"))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
