"""One rank of ``tests/test_torch_multiprocess.py``: four processes as two
"hosts" of two ranks each (``LOCAL_WORLD_SIZE=2``), joined by the port's
``init_distributed`` through a file store, on gloo and the CPU.

Usage: python _torch_mp_worker.py <rank> <world> <store file>
Prints "MP_OK <max_abs_err>" on success.
"""
import os
import sys


def main():
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.dirname(here))
    import numpy as np
    import scipy.sparse.linalg as spla
    import torch

    import _dist_cases as cases
    import sparsemat_tpu_torch as tsm
    from sparsemat_tpu_torch import parallel, solvers
    from sparsemat_tpu_torch.parallel.multihost import host_major_devices

    torch.set_num_threads(1)
    parallel.init_distributed(f"file://{store}", world, rank, device="cpu", timeout=60)
    parallel.init_distributed(f"file://{store}", world, rank, device="cpu")  # ignored
    info = parallel.process_info()
    assert info == {"process_index": rank, "process_count": world, "local_devices": 1,
                    "global_devices": world}, info
    assert host_major_devices().tolist() == list(range(world))

    mesh2 = parallel.make_mesh_2d(device="cpu")
    shape2 = dict(zip(mesh2.mesh_dim_names, mesh2.shape))
    assert shape2 == {"hosts": world // 2, "chips": 2}, shape2
    assert tuple(mesh2.get_coordinate()) == (rank // 2, rank % 2), mesh2.get_coordinate()

    # 2-D 5-point Poisson over the host-major row mesh
    lap = cases.poisson2d(24)
    mesh = parallel.make_host_mesh(device="cpu")
    dA = parallel.distribute_dia(tsm.CSR.from_scipy(lap, device="cpu").to_dia(), mesh)
    x_ref = np.random.default_rng(0).standard_normal(lap.shape[0]).astype(np.float32)
    y = dA.unpad(dA.matvec(dA.padded_vector(x_ref, mesh), mesh)).full_tensor().numpy()
    err_spmv = np.abs(y - lap @ x_ref).max()
    assert err_spmv < 1e-4, f"dist spmv err {err_spmv}"

    b = np.ones(lap.shape[0], np.float32)
    x, sinfo = solvers.cg(lambda v: dA.matvec(v, mesh), dA.padded_vector(b, mesh), tol=1e-6,
                          maxiter=4000)
    x_host = dA.unpad(x).full_tensor().numpy()
    ref = spla.spsolve(lap.astype(np.float64).tocsc(), b.astype(np.float64))
    err_cg = np.abs(x_host - ref).max()
    assert bool(sinfo.converged), "CG did not converge"
    assert err_cg < 1e-3, f"dist CG err {err_cg}"

    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"MP_OK {max(err_spmv, err_cg):.3e}", flush=True)


if __name__ == "__main__":
    main()
