"""Device meshes over the job's processes, and what each process holds.

Counterpart of the JAX package's `leanyolo_tpu/parallel/mesh.py`. A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the job's processes, one
card (or one CPU) each: 1-D ("data",) or 2-D ("dcn", "data") of shape
[nodes, cards per node]. Parameters are replicated (broadcast from rank 0),
each process keeps its rows of the batch, and the collectives of the step
(BatchNorm's moments, the loss normalizer, DDP's gradient buckets) run over
the whole mesh. On NCCL one all-reduce over all ranks is already
hierarchical (NVLink within a node, the network between nodes), so the
hybrid mesh reduces over the same group as the flat one; its two axes tell a
caller which node and which card a rank is.

The 2-D ("data", "space") and ("data", "model") meshes (`make_sp_mesh`,
`make_tp_mesh`) split the batch over `data` only. On a space mesh each rank
holds a band of every image's rows (parallel/spatial.py); on a model mesh a
slice of every layer's output channels (parallel/tensor.py,
`tp_shard_params`). As the JAX docstring says, for a CNN of at most 32 M
parameters data parallelism is the only dimension that pays; these meshes
cut one image's latency across cards, at the cost of an exchange at every
layer.

`image_sharded`, `rows_sharded` and `replicated` say what a rank holds of a
global array, as JAX's shardings of those names place it: a `Placement`
whose call returns this rank's part.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .distributed import BACKENDS, Device, device_type, free_port, global_batch

DATA_AXIS = "data"

DCN_AXIS = "dcn"

SPACE_AXIS = "space"

MODEL_AXIS = "model"


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


def _make_2d_mesh(n_data: int, n_second: int, second_axis: str, device: Device) -> DeviceMesh:
    kind = device_type(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = int(n_data) * int(n_second)
    if need != world:
        raise ValueError(f"requested {need} devices, have {world} (one process a card: start {need} with "
                         f"torchrun --nproc-per-node={need})")
    _ensure_group(kind)
    return init_device_mesh(kind, (int(n_data), int(n_second)), mesh_dim_names=(DATA_AXIS, second_axis))


def make_sp_mesh(n_data: int, n_space: int, *, device: Device = None) -> DeviceMesh:
    """2-D (data, space) mesh for latency-oriented inference: the batch
    splits over `data`, each image's rows over `space` (parallel/spatial.py),
    so a (1, n) mesh runs one image across n processes. n_data * n_space
    must be the process count."""
    return _make_2d_mesh(n_data, n_space, SPACE_AXIS, device)


def make_tp_mesh(n_data: int, n_model: int, *, device: Device = None) -> DeviceMesh:
    """2-D (data, model) mesh for tensor (channel) parallelism: the batch
    splits over `data`, every conv's output channels over `model`
    (parallel/tensor.py). n_data * n_model must be the process count."""
    return _make_2d_mesh(n_data, n_model, MODEL_AXIS, device)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group along `axis` through this rank, or None where the
    axis has one process."""
    if axis not in mesh.mesh_dim_names or mesh.shape[mesh.mesh_dim_names.index(axis)] == 1:
        return None
    return mesh.get_group(axis)


def axis_coordinate(mesh: DeviceMesh, axis: str) -> Tuple[int, int]:
    """(size of `axis`, this rank's index on it)."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.shape[dim], (mesh.get_coordinate()[dim] if mesh.size() > 1 else 0)


def data_position(mesh: DeviceMesh) -> Tuple[int, int]:
    """(processes over the data axes, this rank's index among them)."""
    size, index = 1, 0
    for axis in data_axis_names(mesh):
        n, i = axis_coordinate(mesh, axis)
        size, index = size * n, index * n + i
    return size, index


def data_group(mesh: DeviceMesh):
    """The group over which the batch's rows are split (None: one process
    holds them all)."""
    if mesh.ndim == 2 and mesh.mesh_dim_names[1] in (SPACE_AXIS, MODEL_AXIS):
        return axis_group(mesh, DATA_AXIS)
    return mesh_group(mesh)


class Placement:
    """What this rank holds of a global array: with `batch`, its rows of
    dim 0 over the mesh's data axes; with `band`, of an NHWC image batch on
    a space mesh, also its band of image rows (dim 1)."""

    def __init__(self, mesh: DeviceMesh, batch: bool, band: bool) -> None:
        self.mesh, self.batch, self.band = mesh, batch, band and SPACE_AXIS in mesh.mesh_dim_names

    def rows(self, n_global: int) -> slice:
        if not self.batch:
            return slice(0, n_global)
        size, index = data_position(self.mesh)
        if n_global % size:
            raise ValueError(f"batch {n_global} not divisible by the mesh's {size} data-parallel processes")
        per = n_global // size
        return slice(index * per, (index + 1) * per)

    def __call__(self, a):
        a = a[self.rows(a.shape[0])]
        if self.band:
            from .spatial import plan_bands

            n, pos = axis_coordinate(self.mesh, SPACE_AXIS)
            lo, hi = plan_bands(a.shape[1], n).band(1, pos)
            a = a[:, lo:hi]
        return a


def image_sharded(mesh: DeviceMesh) -> Placement:
    """NHWC image batch: B over the data axes, H over `space` if present."""
    return Placement(mesh, batch=True, band=True)


def rows_sharded(mesh: DeviceMesh) -> Placement:
    """Per-image row tensors (e.g. detections [B, k, 6]): B over the data
    axes, the same on every `space` and `model` rank."""
    return Placement(mesh, batch=True, band=False)


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement(mesh, batch=False, band=False)


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
