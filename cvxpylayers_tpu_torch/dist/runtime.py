"""Multi-process runtime: torch.distributed init, meshes, batch helpers.

Counterpart of cvxpylayers_tpu/dist/runtime.py, on torch.distributed.
Each rank is one device. The only communication a batched cone-program
workload needs is (a) assembling per-rank instance rows into one global
batch and (b) gathering results and reducing losses; per-instance solves
never communicate. So the layout is a 1-D "data" mesh over every rank,
plus an optional 2-D ("host", "chip") mesh for workloads that want
host-local reductions first.

The backend follows the device the caller asks for: NCCL on the card
(the default), gloo on the CPU. It never switches on its own. NCCL puts
one rank on each GPU, so on a machine with one card the world is one
rank.
"""

from __future__ import annotations

import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

from ..parallel.mesh import _require_group, batch_sharding, make_data_mesh

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               device=None) -> bool:
    """Initialize the multi-process runtime (idempotent).

    Pass coordinator_address ("host:port"), num_processes (the world
    size) and process_id (this rank) together: the process group is
    started over `tcp://` with NCCL when `device` is the card (the
    default) and gloo when it is "cpu". `local_device_ids[0]`, when
    given, is the CUDA device this rank uses. Returns True if a process
    group is running (started here or before), False for the
    single-process no-op (nothing given).
    """
    if dist.is_initialized():
        return True
    if (coordinator_address is None and num_processes in (None, 1)
            and process_id is None):
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "pass coordinator_address, num_processes and process_id "
            "together"
        )
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the runtime uses NCCL on CUDA by default and CUDA is not "
                "available; pass device='cpu' for gloo on the CPU"
            )
        if local_device_ids:
            torch.cuda.set_device(int(local_device_ids[0]))
    dist.init_process_group(
        _BACKENDS[dev.type],
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    return True


def make_global_mesh(axis_name: str = "data",
                     device_type: Optional[str] = None) -> DeviceMesh:
    """1-D mesh over every rank of every host — the data-parallel
    layout."""
    return make_data_mesh(device_type, axis_name)


def _ranks_on_this_host() -> int:
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return names.count(names[dist.get_rank()])


def make_host_mesh(axis_names=("host", "chip"),
                   device_type: Optional[str] = None,
                   ranks_per_host: Optional[int] = None) -> DeviceMesh:
    """2-D (host, chip) mesh: shard batches across hosts on the first
    axis and across a host's ranks on the second. `ranks_per_host`
    defaults to the number of ranks that share this rank's host name;
    pass it to lay out simulated hosts on one machine."""
    _require_group()
    world = dist.get_world_size()
    per_host = ranks_per_host or _ranks_on_this_host()
    if world % per_host:
        raise ValueError(
            f"world of {world} ranks is not a whole number of hosts of "
            f"{per_host}"
        )
    return init_device_mesh(device_type or "cuda",
                            (world // per_host, per_host),
                            mesh_dim_names=tuple(axis_names))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def global_batch(local_arr, mesh: DeviceMesh, axis_name: str = "data"):
    """Assemble per-rank local batch rows into one global batch-sharded
    DTensor (each rank contributes the same number of its own instances;
    the global leading dim is the sum over the ranks of `axis_name`). A
    host array is placed on the mesh's device; a tensor must already lie
    there (nothing is copied silently)."""
    dev = _mesh_device(mesh)
    if isinstance(local_arr, torch.Tensor):
        if local_arr.device != dev:
            raise ValueError(
                f"local rows are on {local_arr.device}, the mesh on {dev}"
            )
        local = local_arr
    else:
        local = torch.as_tensor(np.asarray(local_arr), device=dev)
    return DTensor.from_local(local, mesh, batch_sharding(mesh, axis_name))


def host_local_results(global_arr) -> np.ndarray:
    """This rank's rows of a batch-sharded result, as one numpy array (a
    plain tensor is returned whole)."""
    if isinstance(global_arr, DTensor):
        global_arr = global_arr.to_local()
    return global_arr.detach().cpu().numpy()
