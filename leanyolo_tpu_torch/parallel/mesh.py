"""Device meshes over the job's processes, and data-parallel placement.

Counterpart of the data-parallel part of the JAX package's
`leanyolo_tpu/parallel/mesh.py`. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the job's processes, one
card (or one CPU) each: 1-D ("data",) or 2-D ("dcn", "data") of shape
[nodes, cards per node]. Parameters are replicated (broadcast from rank 0),
each process keeps its rows of the batch, and the collectives of the step
(BatchNorm's moments, the loss normalizer, DDP's gradient buckets) run over
the whole mesh. On NCCL one all-reduce over all ranks is already
hierarchical (NVLink within a node, the network between nodes), so the
hybrid mesh reduces over the same group as the flat one; its two axes tell a
caller which node and which card a rank is.

Not ported: the `space` and `model` axes (JAX `make_sp_mesh`, `make_tp_mesh`,
`tp_shard_params`). As the JAX docstring says, for a CNN of at most 32 M
parameters data parallelism is the only dimension that pays: tensor or
spatial parallelism would cut small convolutions below a tile (ROADMAP.md
Queue 1 item 7).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .distributed import BACKENDS, Device, device_type, free_port, global_batch

DATA_AXIS = "data"

DCN_AXIS = "dcn"

#: The axes of the meshes not ported (ROADMAP.md Queue 1 item 7).
SPACE_AXIS = "space"

MODEL_AXIS = "model"

NOT_PORTED = ("spatial and tensor parallelism (the JAX package's make_sp_mesh / make_tp_mesh) are not ported: "
              "ROADMAP.md Queue 1 item 7")


def _ensure_group(kind: str) -> None:
    """A mesh needs a process group: with none started (a world of one,
    distributed.init_distributed), start one of this process alone."""
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[kind], init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)


def make_mesh(n_devices: Optional[int] = None, *, local: bool = False, device: Device = None) -> DeviceMesh:
    """1-D ("data",) mesh over the job's processes, one card each.

    n_devices must be the process count (default). local=True gives a mesh
    of this process alone, whose programs run with no collective (sharded
    multi-process evaluation). device: 'cuda' (the default) or 'cpu'.
    """
    kind = device_type(device)
    _ensure_group(kind)
    world = dist.get_world_size()
    if local:
        if n_devices not in (None, 1):
            raise ValueError(f"a local mesh holds this process's one card, not {n_devices}")
        if world == 1:
            return init_device_mesh(kind, (1,), mesh_dim_names=(DATA_AXIS,))
        return DeviceMesh(kind, [dist.get_rank()], mesh_dim_names=(DATA_AXIS,), _init_backend=False)
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"requested {n} processes, the job has {world} (one process a card: start {n} with "
                         f"torchrun --nproc-per-node={n})")
    return init_device_mesh(kind, (world,), mesh_dim_names=(DATA_AXIS,))


def make_hybrid_mesh(n_hosts: Optional[int] = None, *, device: Device = None) -> DeviceMesh:
    """2-D (dcn, data) mesh of shape [nodes, cards per node].

    n_hosts: the node count; by default the process count over the
    processes a node (torchrun's LOCAL_WORLD_SIZE, else the node's cards on
    'cuda', else one process a node on 'cpu').
    """
    kind = device_type(device)
    _ensure_group(kind)
    world = dist.get_world_size()
    if n_hosts is None:
        per = os.environ.get("LOCAL_WORLD_SIZE")
        per = int(per) if per else (min(torch.cuda.device_count(), world) if kind == "cuda" else 1)
        n_hosts = max(1, world // max(1, per))
    if world % n_hosts:
        raise ValueError(f"{world} processes not divisible into {n_hosts} hosts")
    return init_device_mesh(kind, (n_hosts, world // n_hosts), mesh_dim_names=(DCN_AXIS, DATA_AXIS))


def mesh_group(mesh: DeviceMesh):
    """The process group that spans the mesh's processes, or None for a mesh
    of one process with no group or inside a larger job (nothing to reduce
    over)."""
    if not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if mesh.size() == world:
        return dist.group.WORLD
    if mesh.size() == 1:
        return None
    if mesh.ndim == 1:
        return mesh.get_group()
    raise ValueError(f"a {mesh.ndim}-D mesh must span the job's {world} processes")


def data_axis_names(mesh: DeviceMesh) -> tuple:
    """Mesh axes that carry the batch dimension (all of a data-parallel mesh's)."""
    return tuple(a for a in mesh.mesh_dim_names if a not in (SPACE_AXIS, MODEL_AXIS))


def batch_sharded(mesh: DeviceMesh, n_global: int) -> slice:
    """This rank's rows of a global batch of n_global, split over every mesh
    axis in rank order (a flat and a hybrid mesh split alike)."""
    size = mesh.size()
    if n_global % size:
        raise ValueError(f"batch {n_global} not divisible by the mesh's {size} processes")
    pos = int(np.flatnonzero(mesh.mesh.flatten().numpy() == dist.get_rank())[0]) if size > 1 else 0
    per = n_global // size
    return slice(pos * per, (pos + 1) * per)


def shard_batch(mesh: DeviceMesh, *arrays):
    """This rank's rows of each array (dim 0), as tensors on its device."""
    out = tuple(global_batch(mesh, a[batch_sharded(mesh, a.shape[0])]) for a in arrays)
    return out if len(out) > 1 else out[0]


@torch.no_grad()
def shard_params(mesh: DeviceMesh, module: torch.nn.Module) -> torch.nn.Module:
    """Replicate `module` over the mesh: every state tensor broadcast from
    the mesh's first rank, then loaded again, so that the modules' load
    hooks pack their kernel weights from what arrived (JAX's `replicated`
    placement)."""
    group = mesh_group(mesh)
    if group is None or mesh.size() == 1:
        return module
    src = int(mesh.mesh.flatten()[0])
    state = module.state_dict()
    for t in state.values():
        dist.broadcast(t, src=src, group=group)
    module.load_state_dict(state)
    return module
