"""The six checks of the JAX package's ``dryrun_multichip``, on the port.

``dryrun_multichip(n)`` runs every distributed path once over an n-rank
row mesh, on the mesh's device, and holds each result to scipy: (a) the
DistDIA halo SpMV, (b) distributed CG against a dense solve, (c) the
DistCSR all-gather SpMV, (d) the DistSlab window-halo SpMV, (e) the
DistCSRSubset SpMV, whose one skewed boundary must stay in its own hop,
and (f) bitwise reruns of the DIA SpMV, the CG iterate and residual, and
the subset SpMV.  With n > 1 every rank of the job calls it (after
``init_distributed``); with n = 1 a world of one is started where no
process group exists.
"""

from __future__ import annotations

import numpy as np

from .. import solvers
from ..formats.csr import CSR
from . import dist as pdist
from .mesh import make_mesh, mesh_device


def _check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _host(v) -> np.ndarray:
    """A (gathered) DTensor or tensor as a host numpy array."""
    full = v.full_tensor() if hasattr(v, "full_tensor") else v
    return full.cpu().numpy()


def dryrun_multichip(n_devices: int, *, device=None) -> str:
    """Run the six checks over an ``n_devices``-rank mesh on ``device``
    (None: the current CUDA card; ``"cpu"``: gloo on the CPU).  Raises
    AssertionError where a check fails; returns the summary line."""
    import scipy.sparse as sp

    mesh = make_mesh(n_devices, device=device)
    if mesh.size() != n_devices:
        raise RuntimeError(f"dryrun_multichip: need {n_devices} ranks, the mesh has "
                           f"{mesh.size()}")
    dev = mesh_device(mesh)

    # a 1-D Poisson chain, 16 rows a rank
    n = 16 * n_devices
    lap = sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                   [0, 1, -1], format="csr").astype(np.float32)
    rhs_np = np.ones(n, np.float32)
    dA = pdist.distribute_dia(CSR.from_scipy(lap, device=dev).to_dia(), mesh)
    b = dA.padded_vector(rhs_np, mesh)

    # (a) the halo DIA SpMV against scipy
    y_dia = _host(dA.unpad(dA.matvec(b, mesh)))
    err_dia = np.abs(y_dia - lap @ rhs_np).max()
    _check(err_dia < 1e-5, f"DistDIA SpMV wrong: max abs err {err_dia:.3e}")

    # (b) distributed CG to convergence against a dense solve
    def step(mat, rhs):
        x, info = solvers.cg(lambda v: mat.matvec(v, mesh), rhs, tol=1e-6, maxiter=500)
        return x, info.residual_norm

    x, res = step(dA, b)
    x_np = _host(dA.unpad(x))
    x_ref = np.linalg.solve(lap.toarray().astype(np.float64), rhs_np)
    err_cg = np.abs(x_np - x_ref).max() / np.abs(x_ref).max()
    _check(err_cg < 1e-4, f"distributed CG wrong: rel err {err_cg:.3e}")

    # (c) the all-gather CSR path against scipy
    dC = pdist.distribute_csr(CSR.from_scipy(lap, device=dev), mesh, format="csr")
    y_csr = _host(dC.unpad(dC.matvec(b, mesh)))
    err_csr = np.abs(y_csr - lap @ rhs_np).max()
    _check(err_csr < 1e-5, f"DistCSR SpMV wrong: max abs err {err_csr:.3e}")

    # (d) the window-halo path (DistSlab): 256 rows a rank
    n2 = 256 * n_devices
    lap2 = sp.diags([2.0 * np.ones(n2), -np.ones(n2 - 64), -np.ones(n2 - 64)],
                    [0, 64, -64], format="csr").astype(np.float32)
    dS = pdist.distribute_slab(CSR.from_scipy(lap2, device=dev), mesh, rb=128)
    x2_np = np.random.default_rng(0).standard_normal(n2).astype(np.float32)
    b2 = dS.padded_vector(x2_np, mesh)
    y_slab = _host(dS.unpad(dS.matvec(b2, mesh)))
    err_slab = np.abs(y_slab - lap2 @ x2_np).max()
    _check(err_slab < 1e-4, f"DistSlab SpMV wrong: max abs err {err_slab:.3e}")

    # (e) the subset exchange (DistCSRSubset): a band plus one skewed wide
    # boundary, which must inflate its own hop only
    n3 = 64 * n_devices
    lap3 = sp.diags([2.0 * np.ones(n3), -np.ones(n3 - 3), -np.ones(n3 - 3)],
                    [0, 3, -3], format="csr").astype(np.float32).tolil()
    lap3[1, 64:104] = 0.5            # rank 0 reads 40 columns of rank 1
    lap3 = lap3.tocsr()
    dB = pdist.distribute_csr_subset(CSR.from_scipy(lap3, device=dev), mesh)
    x3_np = np.random.default_rng(1).standard_normal(n3).astype(np.float32)
    b3 = dB.padded_vector(x3_np, mesh)
    y_sub = _host(dB.unpad(dB.matvec(b3, mesh)))
    err_sub = np.abs(y_sub - lap3 @ x3_np).max()
    _check(err_sub < 1e-4, f"DistCSRSubset SpMV wrong: max abs err {err_sub:.1e}")
    # the second-largest hop (none below three ranks) stays band-sized
    _check(sorted(dB.hop_m + (0, 0))[-2] <= 3,
           f"skewed boundary leaked into other hops: hop_m={dB.hop_m}")

    # (f) bitwise reruns on the same mesh: the SpMVs, and the CG iterate
    # stream with its cross-rank reductions
    _check(_host(dA.unpad(dA.matvec(b, mesh))).tobytes() == y_dia.tobytes(),
           "DistDIA SpMV not bitwise-deterministic across runs")
    x_b, res_b = step(dA, b)
    _check(_host(dA.unpad(x_b)).tobytes() == x_np.tobytes(),
           "distributed CG iterates not bitwise-deterministic across runs")
    _check(float(res_b) == float(res), "distributed CG residual not bitwise-deterministic")
    _check(_host(dB.unpad(dB.matvec(b3, mesh))).tobytes() == y_sub.tobytes(),
           "DistCSRSubset SpMV not bitwise-deterministic across runs")

    return (f"dryrun_multichip({n_devices}): verified vs scipy — "
            f"DIA-halo err {err_dia:.1e}; CG rel err {err_cg:.1e} "
            f"(residual {float(res):.1e}); all-gather err {err_csr:.1e}; "
            f"slab halo={dS.halo_windows} err {err_slab:.1e}; "
            f"subset hops={dB.hop_m} err {err_sub:.1e}; "
            f"bitwise-deterministic reruns OK; mesh {mesh.device_type} "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
