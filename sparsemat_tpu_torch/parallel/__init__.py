"""Multi-device distribution layer (counterpart of
``sparsemat_tpu/parallel/``).

The JAX package's 1-D block-row decomposition over a ``torch.distributed``
job, one rank a device:

* a matrix is partitioned on the host into block rows, and each rank keeps
  its block (``DistDIA`` / ``DistCSR`` / ``DistELL`` / ``DistCSRSubset`` /
  ``DistSlab``);
* the SpMV exchanges what each block reads of x (halo edges with the two
  neighbouring ranks for banded and bounded-span matrices, the
  needed-column subsets hop by hop, or all of x), then runs the port's CUDA
  kernel once over the rank's block;
* vectors partitioned by rows are ``DTensor``s placed ``[Shard(0)]``, so
  the solvers' dots reduce across ranks, and ``solvers.cg(lambda v:
  dA.matvec(v, mesh), b)`` runs distributed as written.

Importing it needs no process group and no card.
"""

from .dist import (DistCSR, DistCSRSubset, DistDIA, DistELL, DistSlab, dist_csr_spmv,
                   dist_csr_subset_spmv, dist_dia_spmv, dist_ell_spmv, dist_slab_spmv,
                   distribute_csr, distribute_csr_subset, distribute_dia, distribute_slab)
from .mesh import make_mesh, row_sharding
from .multihost import init_distributed, make_host_mesh, make_mesh_2d, process_info

__all__ = [
    "DistDIA", "DistCSR", "DistCSRSubset", "DistELL", "DistSlab",
    "distribute_dia", "distribute_csr", "distribute_csr_subset",
    "distribute_slab",
    "dist_dia_spmv", "dist_csr_spmv", "dist_csr_subset_spmv",
    "dist_ell_spmv", "dist_slab_spmv",
    "make_mesh", "row_sharding",
    "init_distributed", "make_host_mesh", "make_mesh_2d", "process_info",
]
