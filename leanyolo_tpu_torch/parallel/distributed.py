"""Multi-process start-up, per-process data and the exchanges around them.

Counterpart of the JAX package's `leanyolo_tpu/parallel/distributed.py`. JAX
runs one controller process a host over all of its chips; the port runs one
process a card (`torchrun --nproc-per-node=<cards>`, or one launch a card with
--distributed and a coordinator), joined by `torch.distributed`. The backend
follows the device: NCCL for 'cuda', gloo for 'cpu'.

Nothing here starts a process group at import. With nothing configured, every
entry point is a world of one process.
"""

from __future__ import annotations

import json
import os
import socket
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Device = Union[str, torch.device, None]

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def device_type(device: Device) -> str:
    """'cuda' (the default: entry points run on the card) or 'cpu'."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}: 'cuda' (NCCL) or 'cpu' (gloo)")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("data parallel on the card: no CUDA device; pass device='cpu' (--device cpu) for gloo "
                           "on the CPU")
    return kind


def free_port() -> int:
    """A free TCP port on this host (for a coordinator on 127.0.0.1)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Device = None,
) -> int:
    """Join (or start) the job's process group; returns the process count.

    Explicit arguments win; then LEANYOLO_COORDINATOR / LEANYOLO_NUM_PROCS /
    LEANYOLO_PROC_ID; then torchrun's MASTER_ADDR:MASTER_PORT / WORLD_SIZE /
    RANK. With none of them it is a world of one and no group starts.
    Idempotent: once a group exists, a call returns its size.

    The group is `init_process_group(init_method="tcp://<coordinator>")` with
    the device's backend (NCCL for 'cuda', the default; gloo for 'cpu'). On
    the card each process takes the card LOCAL_RANK names (torchrun), or its
    process id modulo the node's cards. A failed start raises.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("LEANYOLO_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num = env.get("LEANYOLO_NUM_PROCS", env.get("WORLD_SIZE"))
        num_processes = None if num is None else int(num)
    if process_id is None:
        pid = env.get("LEANYOLO_PROC_ID", env.get("RANK"))
        process_id = None if pid is None else int(pid)

    kind = device_type(device)
    if coordinator_address is None and num_processes is None:
        return 1  # nothing configured: a world of one
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            f"init_distributed: coordinator {coordinator_address!r}, {num_processes} processes and process id "
            f"{process_id} — give all three (flags, LEANYOLO_* or torchrun's environment)")
    kwargs = {}
    if kind == "cuda":
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(BACKENDS[kind], init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id), **kwargs)
    return dist.get_world_size()


def global_batch(mesh, *arrays: Any):
    """This process's rows of the global batch, as tensors on this rank's
    device (the card the process owns, or the CPU).

    JAX assembles global arrays from per-process shards; with one process a
    card each process simply keeps its own rows, which the collectives of
    the step (BatchNorm's moments, the loss normalizer, the gradients) join.
    """
    dev = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else torch.device("cpu")
    out = tuple((a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))).to(dev) for a in arrays)
    return out if len(out) > 1 else out[0]


def process_local_slice(n_global: int) -> slice:
    """Row range of the global batch owned by this process (even split)."""
    procs, pid = process_count(), process_index()
    if n_global % procs:
        raise ValueError(f"global batch {n_global} not divisible by {procs} processes")
    per = n_global // procs
    return slice(pid * per, (pid + 1) * per)


def _warm(group, kind: str) -> None:
    dist.barrier(group=group)
    x = torch.ones(1, device="cuda" if kind == "cuda" else "cpu")
    dist.all_reduce(x, group=group)


def cli_distributed_setup(coordinator_address=None, num_processes=None, process_id=None, *,
                          device: Device = None) -> Tuple[int, int]:
    """CLI entry helper: join the job and return (process_count, process_index).

    With more than one process it runs a barrier and a one-element all-reduce
    at once, while the processes are still in lock-step: the transport's
    connections are made here and not at the first step's collective, which
    can come long after on one process (model build, data set scan).
    """
    n = init_distributed(coordinator_address, num_processes, process_id, device=device)
    if n > 1:
        _warm(None, device_type(device))
    return n, process_index()


def warmup_collectives(mesh) -> None:
    """A barrier and a one-element all-reduce over the mesh's processes (see
    cli_distributed_setup); nothing on a mesh of one process."""
    from .mesh import mesh_group

    group = mesh_group(mesh)
    if group is not None and mesh.size() > 1:
        _warm(group, mesh.device_type)


def shard_image_list(images: list, pid: int, nprocs: int) -> list:
    """Disjoint per-process shard of a dataset image list, trimmed so every
    process sees the same number of items (unequal epoch lengths would
    deadlock the collectives at the epoch tail)."""
    n_even = len(images) // nprocs * nprocs
    if n_even == 0:
        raise ValueError(f"{len(images)} images cannot feed {nprocs} processes")
    return images[:n_even][pid::nprocs]


def allgather_obj(obj):
    """Exchange one JSON-serializable object per process; every process
    returns the full list [obj_proc0, obj_proc1, ...] (each passed through
    JSON, as JAX's byte buffers are). One process: [obj].

    `all_gather_object` of the JSON text: no shared file system is assumed.
    Used to merge per-process detections for sharded validation.
    """
    if process_count() == 1:
        return [obj]
    texts = [None] * dist.get_world_size()
    dist.all_gather_object(texts, json.dumps(obj))
    return [json.loads(t) for t in texts]


def add_distributed_args(parser, *, batch_semantics: str) -> None:
    """The shared --distributed/--coordinator/--num-processes/--process-id
    CLI flags (kept in one place so the three tools cannot drift).

    batch_semantics: one line describing what --batch-size means under
    distribution for this tool (global for trainers, per-process for val).
    """
    parser.add_argument(
        "--distributed", action="store_true",
        help="multi-host mode: join a torch.distributed process group; the image list "
        f"shards per process; {batch_semantics}; eval/checkpoints/CSV/logs "
        "come from process 0",
    )
    parser.add_argument("--coordinator", default=None, help="host:port of process 0 (or LEANYOLO_COORDINATOR)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)


def proc0_local_eval(model, predictor, *, imgsz: int, decode: str = "topk", conf_thresh: float = 0.001,
                     device: Device = None):
    """Process-0 evaluation for data-parallel training loops.

    Every process holds the whole model (parameters are replicated), so
    process 0 evaluates with a predictor of its own, on its own device, with
    no collective for the other processes to wait on. The first call builds
    the predictor from a copy of the weights; later calls load the current
    weights into it. Returns (eval_model, predictor): pass the predictor back
    in on the next epoch.
    """
    from ..engine.predictor import Predictor

    if predictor is None:
        predictor = Predictor(model, imgsz=imgsz, decode=decode, conf_thresh=conf_thresh, device=device)
    else:
        predictor.update_params(model)
    return predictor.model, predictor
