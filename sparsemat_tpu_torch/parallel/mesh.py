"""Device meshes over the ranks of a ``torch.distributed`` job (counterpart
of ``sparsemat_tpu/parallel/mesh.py``).

A mesh is a 1-D ``DeviceMesh`` over the row-partition axis: the rank at
coordinate i of the mesh owns row block i, on one device (its current CUDA
card, or the CPU where the caller asks for it).  A vector partitioned by
rows is a ``DTensor`` with the placement ``[Shard(0)]``.  The process group
speaks NCCL on CUDA and gloo on the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..types import resolve_device

ROWS_AXIS = "rows"


def backend_for(device: torch.device) -> str:
    """The collective backend of a device type: NCCL for CUDA, gloo for the
    CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _start_world_of_one(device: torch.device) -> None:
    """A process group of this process alone, on an in-memory store (the
    JAX package needs none for one process).  A failed NCCL start raises:
    there is no quiet move to gloo or the CPU."""
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend_for(device), store=dist.HashStore(), rank=0,
                            world_size=1, **kw)


def make_mesh(n_devices: int | None = None, axis_name: str = ROWS_AXIS, *,
              device=None) -> DeviceMesh:
    """1-D mesh over the row-partition axis: the first ``n_devices`` ranks
    of the job, or all of them.  ``device`` None: the current CUDA card
    (``"cpu"`` asks for the CPU and gloo).  Where no process group exists,
    a world of one is started for a mesh of one; a larger mesh needs
    ``init_distributed`` first."""
    device = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"make_mesh({n_devices}): no process group; call "
                               f"parallel.init_distributed first")
        _start_world_of_one(device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n_devices}): the job has {world} ranks")
    return DeviceMesh(device.type, list(range(n)), mesh_dim_names=(axis_name,))


def row_sharding(mesh: DeviceMesh, axis_name: str = ROWS_AXIS):
    """Placements of a 1-D vector partitioned by rows."""
    return [Shard(0)]


def replicated(mesh: DeviceMesh):
    return [Replicate()]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank holds its part on: the CPU, or its current CUDA
    card."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())
