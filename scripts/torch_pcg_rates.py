"""PCG(Jacobi) iterations/s over the 217,920-row FEM operator frozen to
StripELL and to SlabStream (one row-group plan, one SpMV kernel), the two
alternated in one process on the card, at six stages of the process's life:
fresh; after a walk of the full-size plan; after 20 plain strip SpMVs; after
a plain-strip PCG; after a torch.profiler trace; after ``gc.collect()``.
Each stage prints both formats' rates twice and the number of objects the
garbage collector tracks, so a gap between the formats can be told from a
drift of the host's speed within the process.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_pcg_rates.py
"""
import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch

import chip_smoke as cs
from sparsemat_tpu_torch import solvers, spmv
from sparsemat_tpu_torch.kernels import _rowgroup as krg
from sparsemat_tpu_torch.kernels import strip as ks

ITERS = 256


def rate(A, b, M):
    solvers.cg(A, b, tol=0.0, maxiter=32, M=M)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solvers.cg(A, b, tol=0.0, maxiter=ITERS, M=M)
    torch.cuda.synchronize()
    return ITERS / (time.perf_counter() - t0)


def stage(label, st, ss, b, M):
    r = [rate(st, b, M), rate(ss, b, M), rate(st, b, M), rate(ss, b, M)]
    print(f"{label}: strip {r[0]:.1f} {r[2]:.1f}  stream {r[1]:.1f} {r[3]:.1f}  "
          f"gc objects {len(gc.get_objects())} counts {gc.get_count()}", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_pcg_rates.py needs a CUDA card")
    dev = torch.device("cuda")
    g = cs.gen(dev)
    rows, cols, vals, n, _ = cs.fem_triplets()
    csr, st, _ = cs.assemble_strip(rows, cols, vals, n, dev)
    del rows, cols, vals
    ss = csr.to_slab_stream()
    M = solvers.JacobiPreconditioner.from_matrix(csr)
    b = torch.randn(n, generator=g, device=dev)
    x = torch.randn(n, generator=g, device=dev)
    stage("A fresh", st, ss, b, M)
    krg.spmv_walk(krg.plan_of(st), x)
    torch.cuda.synchronize()
    stage("B after the full-size walk", st, ss, b, M)
    for _ in range(20):
        ks.strip_spmv_ref(st, x)
    torch.cuda.synchronize()
    stage("C after 20 plain strip SpMVs", st, ss, b, M)
    t0 = time.perf_counter()
    solvers.cg(lambda v: ks.strip_spmv_ref(st, v), b, tol=0.0, maxiter=64, M=M)
    torch.cuda.synchronize()
    print(f"plain strip PCG {64 / (time.perf_counter() - t0):.1f} iters/s", flush=True)
    stage("D after the plain PCG", st, ss, b, M)
    cs.device_us(lambda: spmv(st, x), 20, "rowgroup_spmv_kernel",
                 lambda: krg.LAUNCHES["strip_spmv"])
    stage("E after a profiler trace", st, ss, b, M)
    gc.collect()
    stage("F after gc.collect", st, ss, b, M)


if __name__ == "__main__":
    main()
