"""Training engine: one train step = augment, forward, dual-TAL loss, backward,
per-group clip, AdamW, BN running statistics.

Counterpart of the JAX package's `leanyolo_tpu/engine/trainer.py` (reference
`tools/train.py:135-309`, `tools/transfer_learn_aquarium.py`), numerically
step for step:

- two parameter groups, backbone+neck and head (`label_params`); the BN
  running statistics and the input-normalization buffers are buffers, never
  optimized;
- each group is clipped by ITS OWN global norm (optax `multi_transform` of
  `clip_by_global_norm`): g / norm * max_norm when norm >= max_norm, with
  no epsilon;
- AdamW (b1 0.9, b2 0.999, eps 1e-8), weight decay on every parameter of a
  group; a group's lr is its warmup-cosine schedule at the step count before
  the increment;
- freezing sets `requires_grad=False` on the backbone+neck and clears grads
  to None, so AdamW skips those parameters entirely (no gradient, no decay,
  no step count), which is what the JAX step's count rewind and zeroed
  updates amount to; the schedule advances all the same;
- mixed precision is bf16 activations over fp32 parameters and gradients;
  the loss runs in fp32 on head maps upcast level by level;
- BN running statistics advance in the forward (layers.BatchNorm), once a
  step also under activation checkpointing (`remat="full"`);
- with `device_preprocess` the step takes a `DeviceBatch` (raw pixels on a
  fixed canvas) and letterboxes it on the device, mapping the GT boxes as
  x * gain + pad, then augments or casts as the host path does;
- on a mesh (`parallel/mesh.py`, one process a card) each process steps on
  its rows of the global batch, and the step equals the one-process step on
  the global batch, as JAX's GSPMD step does: the augmentation draws the
  global batch's uniforms and takes this process's rows, BatchNorm's moments
  and the loss normalizer are summed over the mesh
  (`layers.global_batch_stats`, `detection_loss_v10(group=)`), and DDP sums
  the gradients (a comm hook in place of its mean), one wrapper a freeze
  phase, so every process clips and steps alike; the losses returned are the
  global batch's.

It runs on the card unless the caller names another device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.yolov10.layers import global_batch_stats
from ..models.yolov10.losses import detection_loss_v10
from ..models.yolov10.model import YOLOv10
from ..ops.letterbox import letterbox_batch

Tensor = torch.Tensor


@dataclass
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 5e-4
    epochs: int = 10
    warmup_epochs: int = 1
    bb_lr_mult: float = 0.1  # backbone+neck lr multiplier
    freeze_backbone: bool = False
    unfreeze_epoch: int = 5
    grad_clip: float = 1.0
    bf16: bool = False
    augment: bool = False
    p_hflip: float = 0.5
    p_bc: float = 0.5
    steps_per_epoch: int = 100  # for the per-epoch schedule
    #: 'none' keeps every activation for the backward; 'full' checkpoints
    #: the forward node by node (YOLOv10.forward(remat=True)): the backward
    #: recomputes the activations, one extra forward for less memory.
    remat: str = "none"
    #: The step takes a DeviceBatch and letterboxes it on the device.
    device_preprocess: bool = False
    #: Square letterbox size (device_preprocess: a DeviceBatch made for
    #: another size raises; the host path takes its size from the dataset).
    imgsz: int = 640


def label_params(model: YOLOv10) -> Dict[str, str]:
    """Parameter name -> 'backbone' (backbone and neck) or 'head'."""
    return {name: ("backbone" if name.split(".")[0] in ("backbone", "neck") else "head")
            for name, _ in model.named_parameters()}


def warmup_cosine_schedule(lr: float, *, epochs: int, warmup_epochs: int, steps_per_epoch: int) -> Callable[[int], float]:
    """Per-epoch warmup -> cosine, constant within an epoch, computed in fp32
    as the JAX schedule is."""
    e_total = max(1, epochs)
    wu = max(0, min(warmup_epochs, e_total))
    f32 = np.float32

    def schedule(step: int) -> float:
        epoch = step // max(1, steps_per_epoch)
        if wu > 0 and epoch < wu:
            factor = f32(epoch + 1.0) / f32(max(wu, 1))
        else:
            t = f32(epoch - wu) / f32(max(1, e_total - wu))
            factor = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * t))
        return float(f32(lr) * f32(factor))

    return schedule


def make_optimizer(model: YOLOv10, cfg: TrainConfig):
    """AdamW over the 'head' and 'backbone' groups, and each group's schedule."""
    labels = label_params(model)
    named = dict(model.named_parameters())
    scheds = {
        "head": warmup_cosine_schedule(cfg.lr, epochs=cfg.epochs, warmup_epochs=cfg.warmup_epochs,
                                       steps_per_epoch=cfg.steps_per_epoch),
        "backbone": warmup_cosine_schedule(cfg.lr * cfg.bb_lr_mult, epochs=cfg.epochs,
                                           warmup_epochs=cfg.warmup_epochs, steps_per_epoch=cfg.steps_per_epoch),
    }
    groups = [{"params": [p for n, p in named.items() if labels[n] == g], "name": g, "lr": scheds[g](0)}
              for g in ("head", "backbone")]
    opt = torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    return opt, scheds


def augment_batch(generator: torch.Generator, images: Tensor, gt_boxes: Tensor, *, p_hflip: float, p_bc: float,
                  dtype: Optional[torch.dtype] = None, shard: Tuple[int, int] = (0, 1)):
    """Horizontal flip + brightness/contrast in letterbox space, per image
    (JAX `augment_batch`: alpha in [0.8, 1.2], beta in [-16, 16], clamp to
    [0, 255]; flipped boxes are mirrored). The flip runs before the cast to
    `dtype`, on the uint8 pixels. Four draws of B uniforms from `generator`
    (flip, jitter, alpha, beta), on the generator's device.

    shard=(i, k): the B images are part i of a global batch of k * B, whose
    draws are made (k * B uniforms each) and cut to this part's rows, so k
    processes with one seed augment as one process would.
    """
    if dtype is None and not images.is_floating_point():
        raise ValueError("augment_batch: integer (uint8) images need an explicit float `dtype`: the brightness "
                         "jitter in integer arithmetic would truncate alpha to 0/1 and wrap beta")
    b, w = images.shape[0], images.shape[2]
    i, k = shard
    u = [torch.rand(b * k, generator=generator, device=generator.device)[i * b:(i + 1) * b].to(images.device)
         for _ in range(4)]
    do_flip = u[0] < p_hflip
    images = torch.where(do_flip[:, None, None, None], images.flip(2), images)
    if dtype is not None:
        images = images.to(dtype)
    x1, y1, x2, y2 = gt_boxes.unbind(-1)
    flipped = torch.stack([w - x2, y1, w - x1, y2], dim=-1)
    gt_boxes = torch.where(do_flip[:, None, None], flipped, gt_boxes)

    do_bc = u[1] < p_bc
    alpha = (0.8 + 0.4 * u[2]).to(images.dtype)
    beta = (u[3] * 32.0 - 16.0).to(images.dtype)
    jittered = torch.clamp(images * alpha[:, None, None, None] + beta[:, None, None, None], 0.0, 255.0)
    images = torch.where(do_bc[:, None, None, None], jittered, images)
    return images, gt_boxes


def _sum_hook(group, bucket):
    """DDP comm hook: the bucket's gradients summed over the group (DDP's
    default averages; each process's loss is already its share of the
    global loss, so its gradients sum to the global gradient)."""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


class Trainer:
    """Owns the optimizer and runs train steps on `model` in place.

    Args:
        model: a YOLOv10 module with fp32 parameters; it is moved to
            `device` (channels_last on the card) and put in training mode.
        cfg: the TrainConfig.
        mesh: a DeviceMesh over the job's processes (parallel/mesh.py) to
            train data-parallel on, each process on its rows of the global
            batch and its own device; None trains on this process's batch.
        device: where to train; None means the card ('cuda', this process's
            card), and raises when there is none.
    """

    #: GT-count buckets: the assignment is O(B * Nmax * A); a batch is cut to
    #: the smallest bucket that holds its fullest image.
    NMAX_BUCKETS = (8, 16, 32, 64, 128)

    def __init__(self, model: YOLOv10, cfg: TrainConfig, *, mesh=None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if cfg.remat not in ("none", "full"):
            raise ValueError(f"unknown remat mode {cfg.remat!r} (use 'none' or 'full')")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to train on the CPU")
        self.model = model.to(self.device).train()
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.cfg = cfg
        self.dtype = torch.bfloat16 if cfg.bf16 else torch.float32
        self.opt, self.schedules = make_optimizer(self.model, cfg)
        self.global_step = 0
        self.mesh = mesh
        self._group, self._shard = None, (0, 1)
        if mesh is not None:
            from ..parallel.mesh import batch_sharded, mesh_group

            self._group = mesh_group(mesh)
            if self._group is not None:
                self._shard = (batch_sharded(mesh, mesh.size()).start, mesh.size())
        self._ddp: Dict[bool, torch.nn.Module] = {}  # the DDP wrapper of the current freeze phase
        self._rows_checked = 0  # the local batch size every process was found to hold

    @property
    def frozen(self) -> bool:
        epoch = self.global_step // max(1, self.cfg.steps_per_epoch)
        return self.cfg.freeze_backbone and epoch < self.cfg.unfreeze_epoch

    def _nmax_bucket(self, gt_mask) -> int:
        nmax = gt_mask.shape[1]
        if not nmax:
            return nmax
        counts = gt_mask.sum(1) if torch.is_tensor(gt_mask) else np.sum(np.asarray(gt_mask), axis=1)
        need = int(counts.max())
        for b in self.NMAX_BUCKETS:
            if need <= b <= nmax:
                return b
        return nmax

    def _tensor(self, a) -> Tensor:
        t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, non_blocking=True)

    def _network(self, frozen: bool) -> torch.nn.Module:
        """The module the step calls: the model, or on a mesh its DDP
        wrapper for this freeze phase (built over the parameters that take
        gradients in it; a new phase replaces the wrapper)."""
        if self._group is None:
            return self.model
        if frozen not in self._ddp:
            from torch.nn.parallel import DistributedDataParallel

            ddp = DistributedDataParallel(self.model, process_group=self._group, broadcast_buffers=False)
            ddp.register_comm_hook(self._group, _sum_hook)
            self._ddp = {frozen: ddp}
        return self._ddp[frozen]

    def _check_rows(self, b: int) -> None:
        """Every process must hold the same number of rows (the global
        statistics count n x processes); checked when the local size changes."""
        if b == self._rows_checked:
            return
        sizes = [torch.zeros(1, dtype=torch.int64, device=self.device) for _ in range(self._shard[1])]
        dist.all_gather(sizes, torch.full((1,), b, dtype=torch.int64, device=self.device), group=self._group)
        sizes = [int(t) for t in sizes]
        if len(set(sizes)) != 1:
            raise ValueError(f"data-parallel step: the processes hold {sizes} rows; each must hold the same number")
        self._rows_checked = b

    def forward_backward(self, batch, generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """Augment, forward, loss and backward on `batch` (attributes images
        [B,S,S,3] uint8, gt_labels [B,N], gt_boxes [B,N,4] xyxy pixels,
        gt_mask [B,N]; or a DeviceBatch with device_preprocess); leaves the
        gradients in `.grad` (None for frozen parameters) and returns the
        detached losses {'total', 'cls', 'reg'}."""
        cfg = self.cfg
        is_device_batch = hasattr(batch, "canvas")
        if is_device_batch != cfg.device_preprocess:
            raise ValueError(
                f"batch/preprocess mismatch: TrainConfig.device_preprocess={cfg.device_preprocess} but the loader "
                f"produced a {'DeviceBatch' if is_device_batch else 'host Batch'}; build the dataset with the "
                "matching preprocess= mode")
        if is_device_batch and batch.img_size != cfg.imgsz:
            raise ValueError(f"batch/preprocess mismatch: the DeviceBatch's geometry is for a {batch.img_size} px "
                             f"letterbox but TrainConfig.imgsz={cfg.imgsz}; build the dataset with img_size=imgsz")
        frozen = self.frozen
        for name, p in self.model.named_parameters():
            if name.split(".")[0] in ("backbone", "neck"):
                p.requires_grad_(not frozen)
        network = self._network(frozen)
        self.opt.zero_grad(set_to_none=True)
        if self._group is not None:
            self._check_rows(int(batch.gt_mask.shape[0]))

        nb = self._nmax_bucket(batch.gt_mask)
        gt_labels = self._tensor(batch.gt_labels[:, :nb])
        gt_boxes = self._tensor(batch.gt_boxes[:, :nb])
        gt_mask = self._tensor(batch.gt_mask[:, :nb])
        if is_device_batch:
            # Warp the raw canvas to the letterbox square (fp32) and map the
            # boxes from original pixels: x' = x * gain + pad.
            images = letterbox_batch(self._tensor(batch.canvas), batch.new_hw, batch.pads, batch.hw, cfg.imgsz)
            gainpad = self._tensor(batch.gainpad)
            gt_boxes = gt_boxes * gainpad[:, None, [0, 1, 0, 1]] + gainpad[:, None, [2, 3, 2, 3]]
        else:
            images = self._tensor(batch.images)
        if cfg.augment:
            if generator is None:
                raise ValueError("train_step: augment=True needs a torch.Generator")
            images, gt_boxes = augment_batch(generator, images, gt_boxes, p_hflip=cfg.p_hflip, p_bc=cfg.p_bc,
                                             dtype=self.dtype, shard=self._shard)
        else:
            images = images.to(self.dtype)

        with global_batch_stats(self._group):
            raw = network(images, dtype=self.dtype, concat_head=False, remat=cfg.remat == "full")
        raw = {k: [(r.float(), c.float()) for r, c in v] for k, v in raw.items()}
        mcfg = self.model.cfg
        losses = detection_loss_v10(raw, gt_labels, gt_boxes, gt_mask, num_classes=self.model.nc,
                                    reg_max=mcfg.reg_max, strides=tuple(mcfg.strides), group=self._group)
        losses["total"].backward()
        losses = {k: v.detach() for k, v in losses.items()}
        if self._group is not None:  # this process's share -> the global batch's losses
            shares = torch.stack(list(losses.values()))
            dist.all_reduce(shares, group=self._group)
            losses = dict(zip(losses, shares.unbind()))
        return losses

    def optimizer_step(self) -> None:
        """Clip each group by its own global norm, set each group's lr from
        its schedule at the current step, and step AdamW on the `.grad`s."""
        max_norm = self.cfg.grad_clip
        for group in self.opt.param_groups:
            group["lr"] = self.schedules[group["name"]](self.global_step)
            grads: List[Tensor] = [p.grad for p in group["params"] if p.grad is not None]
            if not grads or not (max_norm and max_norm > 0):
                continue
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < max_norm
            one = torch.ones((), device=norm.device)
            # optax: t / norm * max_norm, two roundings, only when norm >= max_norm.
            torch._foreach_div_(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
        self.opt.step()

    def train_step(self, batch, generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """One optimizer step on `batch`; returns the losses as 0-d tensors
        on the training device (reading them waits for the step)."""
        losses = self.forward_backward(batch, generator)
        self.optimizer_step()
        self.global_step += 1
        return losses

    # -- resume: the optimizer, the step counter and the model in one file ---

    def save_train_state(self, path: str) -> None:
        """Model state (parameters and BN statistics), optimizer state and
        step counter -> one torch file; on a mesh, process 0 writes it (the
        state is the same on every process)."""
        if self._shard[0] == 0:
            torch.save({"model": self.model.state_dict(), "optimizer": self.opt.state_dict(),
                        "global_step": self.global_step}, path)

    def load_train_state(self, path: str) -> None:
        """Strict restore into this trainer's model and optimizer (on a mesh,
        every process reads the one file)."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"], strict=True)
        self.opt.load_state_dict(state["optimizer"])
        self.global_step = int(state["global_step"])
