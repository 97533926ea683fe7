"""The port's distribution layer in a 4-rank gloo job on the CPU, held to
the JAX package on ``make_mesh(4)`` on the same seeded inputs.

One job runs every check (``tests/_torch_dist_worker.py``, four processes
joined through a file store in ``tmp_path``): each distributed SpMV
(DistDIA with its halo and its all-gather fallback, DistCSR, DistELL,
DistCSRSubset, DistSlab; uneven rows), the slab halo guard, CG through
DistDIA (1-D Poisson in f64, the 27-point stencil in f64 and f32) and
DistSlab (the ±1, ±130 operator in f64, 2-D Poisson in f32), bitwise
reruns, and the port's ``dryrun_multichip(4)``.  A rank
that hangs is killed at the job's time limit and fails the job.

Tolerances, relative to max |reference|: f64 1e-10, f32 1e-5 (another
summation order in the shard products and the cross-rank dots).  CG
iteration counts are equal to the JAX distributed CG's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import _dist_cases as cases
import _torch_dist_worker as worker
from _torch_cpu import LazyModule, port_on_cpu  # noqa: F401  (autouse: the tests ask for the CPU)

jsm = LazyModule("sparsemat_tpu")
jpar = LazyModule("sparsemat_tpu.parallel")
jsolvers = LazyModule("sparsemat_tpu.solvers")

WORLD = 4
#: seconds the whole job may take before its ranks are killed
JOB_TIMEOUT = 240


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dist")
    out = tmp / "results.npz"
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(rank), str(WORLD),
                               str(tmp / "store"), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOB_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-3000:]}"
        assert "DIST_OK" in text, f"rank {rank} did not finish:\n{text[-3000:]}"
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def _mesh4():
    return jpar.make_mesh(WORLD)


def _jax_dist(name, how, kw, mesh):
    m = worker.MATRICES[name]()
    csr = jsm.CSR.from_scipy(m)
    if how == "dia":
        return m, jpar.distribute_dia(csr.to_dia(), mesh)
    return m, getattr(jpar, f"distribute_{how}")(csr, mesh, **kw)


def _close(got, want, dtype):
    tol = 1e-10 if dtype == np.float64 else 1e-5
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - np.asarray(want, np.float64)).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


@pytest.mark.parametrize("case", sorted(worker.SPMV))
def test_dist_spmv_matches_reference(job, case):
    name, how, kw = worker.SPMV[case]
    mesh = _mesh4()
    m, jd = _jax_dist(name, how, kw, mesh)
    x = worker.x_for(case, m.shape[0], m.dtype)
    want = np.asarray(jd.unpad(jd.matvec(jd.padded_vector(x, mesh), mesh)))
    _close(job[case], want, m.dtype)
    _close(job[case], m @ x, m.dtype)


def test_dia_allgather_fallback_was_taken(job):
    assert bool(job["allgather_halo_gt_rows"])


def test_slab_halo_guard_raises_as_reference(job):
    mesh = _mesh4()
    _, jd = _jax_dist("random1000", "slab", {"rb": 128}, mesh)
    with pytest.raises(ValueError) as want:
        jd.matvec(jd.padded_vector(np.ones(1000, np.float32), mesh), mesh)
    assert str(job["slab_guard"]) == str(want.value)


@pytest.mark.parametrize("case", sorted(worker.CG))
def test_dist_cg_matches_reference(job, case):
    name, how, kw, tol, maxiter, kind = worker.CG[case]
    mesh = _mesh4()
    m, jd = _jax_dist(name, how, kw, mesh)
    bs = jd.padded_vector(worker.rhs_for(m, kind), mesh)
    x, info = jsolvers.cg(lambda v: jd.matvec(v, mesh), bs, tol=tol, maxiter=maxiter)
    assert bool(job[case + "_converged"]) and bool(info.converged)
    assert int(job[case + "_iterations"]) == int(info.iterations)
    _close(job[case], np.asarray(jd.unpad(x)), m.dtype)


def test_dryrun_multichip_four_ranks(job):
    line = str(job["dryrun"])
    assert line.startswith("dryrun_multichip(4): verified vs scipy")
    assert "bitwise-deterministic reruns OK" in line and "subset hops=(3, 1, 40)" in line


def test_cpu_shard_products_launch_no_kernel(job):
    assert int(job["launches"]) == 0
