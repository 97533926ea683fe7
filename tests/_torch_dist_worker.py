"""One rank of the port's 4-rank distribution job (``tests/test_torch_dist.py``).

Usage: python _torch_dist_worker.py <rank> <world> <store file> <out.npz>

Every rank joins a gloo job through a file store, runs the port's
distributed SpMVs, CGs and ``dryrun_multichip`` on the matrices of
``tests/_dist_cases.py`` over a 4-rank CPU mesh, and checks its reruns
bitwise; rank 0 writes the gathered results to <out.npz> for the test
process, which holds them against the JAX package.  Imports torch and the
port only.  Prints "DIST_OK" on success.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import _dist_cases as cases  # noqa: E402

#: the SpMV cases: name → (matrix, distribute function, its keyword arguments)
SPMV = {
    "dia_band3": ("band3", "dia", {}),
    "dia_uneven237": ("uneven237", "dia", {}),
    "dia_allgather_band40": ("band40", "dia", {}),
    "dia_stencil27": ("stencil27", "dia", {}),
    "csr_random300": ("random300", "csr", {"format": "csr"}),
    "ell_random300": ("random300", "csr", {"format": "ell"}),
    "csr_uneven237": ("uneven237", "csr", {"format": "csr"}),
    "ell_skewed": ("skewed", "csr", {"format": "ell"}),
    "subset_subset257": ("subset257", "csr_subset", {}),
    "subset_skewed": ("skewed", "csr_subset", {}),
    "subset_random1000": ("random1000", "csr_subset", {}),
    "slab_scattered": ("scattered", "slab", {"rb": 128}),
    "slab_uneven": ("uneven_slab", "slab", {"rb": 128}),
}
#: the CG cases: name → (matrix, distribute function, its keyword arguments, tol, maxiter,
#: right-hand side: "ones" or "random").  The f32 cases stop above the rounding floor
#: of f32 CG on their operator: below it the count and the iterate follow the order
#: of the dots' partial sums (the JAX package's own count on the 27-point stencil at
#: tol 1e-5 moves from 24 to 28 between 4 and 8 devices), so two packages cannot
#: agree there
CG = {
    "cg_dia_poisson1d_f64": ("poisson1d_512", "dia", {}, 1e-10, 20000, "random"),
    "cg_dia_stencil27_f64": ("stencil27_f64", "dia", {}, 1e-10, 2000, "ones"),
    "cg_dia_stencil27_f32": ("stencil27", "dia", {}, 1e-4, 2000, "ones"),
    "cg_slab_lap_f64": ("slab_lap_f64", "slab", {"rb": 128}, 1e-10, 2000, "ones"),
    "cg_slab_poisson2d_f32": ("poisson2d_64", "slab", {"rb": 128}, 1e-5, 2000, "ones"),
}
MATRICES = dict(cases.MATRICES, poisson1d_512=lambda: cases.poisson1d(512),
                stencil27_f64=lambda: cases.stencil27(12).astype(np.float64),
                slab_lap_f64=lambda: cases.slab_lap().astype(np.float64),
                poisson2d_64=lambda: cases.poisson2d(64))


def x_for(name, n, dtype):
    """The SpMV operand of a case (the same seed in both packages)."""
    seed = sorted(SPMV).index(name) + 100
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def rhs_for(m, kind):
    if kind == "ones":
        return np.ones(m.shape[0], m.dtype)
    x_true = np.random.default_rng(6).standard_normal(m.shape[0]).astype(m.dtype)
    return (m @ x_true).astype(m.dtype)


def main():
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import torch

    import sparsemat_tpu_torch as tsm
    from sparsemat_tpu_torch import interop, parallel, solvers
    from sparsemat_tpu_torch.parallel import dist as pdist
    from sparsemat_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.set_num_threads(1)
    parallel.init_distributed(f"file://{store}", world, rank, device="cpu", timeout=60)
    mesh = parallel.make_mesh(world, device="cpu")

    def distribute(name, how, kw):
        m = MATRICES[name]()
        csr = tsm.CSR.from_scipy(m, device="cpu")
        if how == "dia":
            return m, parallel.distribute_dia(csr.to_dia(), mesh)
        return m, getattr(parallel, f"distribute_{how}")(csr, mesh, **kw)

    def full(v):
        return v.full_tensor().numpy()

    results = {}
    for case, (name, how, kw) in SPMV.items():
        m, d = distribute(name, how, kw)
        xs = d.padded_vector(x_for(case, m.shape[0], m.dtype), mesh)
        y = full(d.unpad(d.matvec(xs, mesh)))
        again = full(d.unpad(d.matvec(xs, mesh)))
        assert again.tobytes() == y.tobytes(), f"{case}: rerun not bitwise equal"
        results[case] = y
    results["allgather_halo_gt_rows"] = np.array(
        distribute("band40", "dia", {})[1].halo > 128 // world)

    _, guard = distribute("random1000", "slab", {"rb": 128})
    try:
        guard.matvec(guard.padded_vector(np.ones(1000, np.float32), mesh), mesh)
        results["slab_guard"] = np.array("no error")
    except ValueError as e:
        results["slab_guard"] = np.array(str(e))

    for case, (name, how, kw, tol, maxiter, kind) in CG.items():
        m, d = distribute(name, how, kw)
        bs = d.padded_vector(rhs_for(m, kind), mesh)
        x, info = solvers.cg(lambda v: d.matvec(v, mesh), bs, tol=tol, maxiter=maxiter)
        x_np = full(d.unpad(x))
        results[case] = x_np
        results[case + "_iterations"] = np.array(int(info.iterations))
        results[case + "_converged"] = np.array(bool(info.converged))
        x2, info2 = solvers.cg(lambda v: d.matvec(v, mesh), bs, tol=tol, maxiter=maxiter)
        assert full(d.unpad(x2)).tobytes() == x_np.tobytes(), f"{case}: rerun not bitwise"
        assert float(info2.residual_norm) == float(info.residual_norm), case

    # from_reference of the port's own partition at four blocks is its distribute_*
    csr = tsm.CSR.from_scipy(cases.skewed(), device="cpu")
    own = parallel.distribute_csr_subset(csr, mesh)
    back = interop.from_reference(pdist.partition_csr_subset(csr, world), format="dist_csr_subset",
                                  shape=csr.shape, mesh=mesh)
    assert back.hop_m == own.hop_m and all(
        torch.equal(a, b) for a, b in zip(back.send_idx + (back.indices, back.data),
                                          own.send_idx + (own.indices, own.data)))
    results["dryrun"] = np.array(dryrun_multichip(world, device="cpu"))
    results["launches"] = np.array(sum(pdist.LAUNCHES.values()))
    if rank == 0:
        np.savez(out, **results)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("DIST_OK", flush=True)


if __name__ == "__main__":
    main()
