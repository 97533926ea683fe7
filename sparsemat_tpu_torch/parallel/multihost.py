"""Multi-host (multi-process) runtime glue (counterpart of
``sparsemat_tpu/parallel/multihost.py``).

One process drives one device.  ``init_distributed`` joins the job's
process group; ``make_host_mesh`` is a 1-D row mesh whose order is
host-major, so consecutive row blocks sit on one host and the halo
exchanges of ``DistDIA``/``DistSlab`` cross hosts once per host boundary;
``make_mesh_2d`` is the (hosts × devices a host) mesh; ``process_info``
says where this process stands in the job.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..types import resolve_device
from .mesh import ROWS_AXIS, backend_for

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, *, device=None,
                     timeout: float | None = None) -> None:
    """Join the job's process group: ``init_process_group`` at
    ``coordinator_address`` ("host:port" is read as ``tcp://host:port``; a
    URL such as ``file:///path`` is passed on; None reads the ``env://``
    variables), with ``num_processes`` ranks, as rank ``process_id``.  On
    CUDA (``device`` None) the rank drives ``cuda:local_device_ids[0]``, or
    its local rank's card, under NCCL; ``device="cpu"`` runs the job on the
    CPU under gloo (``mesh.backend_for``).  ``timeout`` (seconds) bounds
    each collective.  One process (``num_processes=1`` and no
    address) needs nothing: ``make_mesh`` starts a world of one.  A second
    call is ignored."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    if num_processes == 1 and coordinator_address is None:
        _initialized = True
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {}
    if timeout is not None:
        kw["timeout"] = timedelta(seconds=timeout)
    kind = resolve_device(device)
    if kind.type == "cuda":
        if local_device_ids is not None:
            index = int(list(local_device_ids)[0])
        else:
            index = int(os.environ.get("LOCAL_RANK", process_id or 0)) % torch.cuda.device_count()
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend_for(kind), init_method=init_method, rank=process_id,
                            world_size=num_processes, **kw)
    _initialized = True


def _host_and_local_rank() -> list[tuple[int, int]]:
    """(host, local rank) of every rank: from ``LOCAL_WORLD_SIZE`` where it
    is set (ranks host-contiguous, as ``torchrun`` numbers them), else from
    an all-gather of the host names, hosts numbered in order of their first
    rank."""
    world = dist.get_world_size()
    per_host = os.environ.get("LOCAL_WORLD_SIZE")
    if per_host:
        return [divmod(r, int(per_host)) for r in range(world)]
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    hosts = list(dict.fromkeys(names))
    return [(hosts.index(n), names[:r].count(n)) for r, n in enumerate(names)]


def host_major_devices() -> np.ndarray:
    """Every rank of the job, ordered host-major (host, then local rank),
    so the row-block → rank assignment is deterministic."""
    if not dist.is_initialized():
        return np.zeros(1, np.int64)
    keys = _host_and_local_rank()
    return np.array(sorted(range(len(keys)), key=keys.__getitem__), np.int64)


def make_host_mesh(axis_name: str = ROWS_AXIS, *, device=None) -> DeviceMesh:
    """1-D row mesh over every rank of the job, host-major: row block i
    lands on host i // devices-a-host, so ``DistDIA``'s halo ring crosses
    hosts once per host boundary."""
    device = resolve_device(device)
    return DeviceMesh(device.type, host_major_devices().tolist(), mesh_dim_names=(axis_name,))


def make_mesh_2d(host_axis: str = "hosts", chip_axis: str = "chips", *,
                 device=None) -> DeviceMesh:
    """(hosts × devices a host) mesh: the outer axis spans hosts, the inner
    the devices of one host.  Raises where hosts hold unequal counts."""
    device = resolve_device(device)
    ranks = host_major_devices()
    hosts = [h for h, _ in _host_and_local_rank()] if dist.is_initialized() else [0]
    n_hosts = len(set(hosts))
    per_host = ranks.size // n_hosts
    if any(hosts.count(h) != per_host for h in set(hosts)):
        raise ValueError(f"uneven device count: {ranks.size} devices over {n_hosts} hosts")
    return DeviceMesh(device.type, ranks.reshape(n_hosts, per_host).tolist(),
                      mesh_dim_names=(host_axis, chip_axis))


def process_info() -> dict:
    """This process's place in the job (one device a process)."""
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    return {"process_index": dist.get_rank() if on else 0, "process_count": world,
            "local_devices": 1, "global_devices": world}
