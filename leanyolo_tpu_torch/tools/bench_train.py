"""Training benchmark: a YOLOv10 variant's end-to-end training throughput on
one card.

    python -m leanyolo_tpu_torch.tools.bench_train [--variant yolov10s] [--imgsz 640]
        [--batch-sizes 32,128] [--nboxes 24] [--remat none|full] [--device cuda|cpu]

Counterpart of the JAX package's `bench_train.py`, with its flags, its JSON
line and its metric name (`{variant}_{imgsz}_bf16_train_images_per_sec_per_chip`).
Each batch size gets a fresh model (80 classes, random weights) and
`Trainer(model, TrainConfig(bf16=True, augment=True, grad_clip=1.0,
steps_per_epoch=1000, remat=...))`: the augmentation, the forward, the
two assignments and the loss, the backward, the clipped AdamW step. The
synthetic batch is bench_train.py's draw (`synthetic_batch`): up to
`nboxes` boxes 8-60 px an image, 40% of the slots valid. Its images,
labels and boxes are uploaded once; the [bs, nboxes] mask stays on the host,
where the trainer picks its GT bucket.

Throughput is steps x bs / wall: `steps` warm-up steps, then `steps` timed
steps back to back with one synchronize after the last. The JAX bench ran
its steps in one `fori_loop` program, a remote TPU's workaround; eager
PyTorch runs every step as it comes. A batch size that does not fit
(`torch.OutOfMemoryError`) ends the sweep; any other error propagates.
"""

from __future__ import annotations

import argparse
import json
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.profiling import chain_s
from .bench import NC, build_model, check_device, device_detail, free_device


def synthetic_batch(bs: int, imgsz: int, nboxes: int = 24, seed: int = 0) -> tuple:
    """(images uint8 [bs, S, S, 3], labels int32 [bs, n], boxes xyxy float32
    [bs, n, 4], mask bool [bs, n]) from RandomState(seed), in bench_train.py's
    order of draws."""
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(0, imgsz - 60, (2, bs, nboxes)).astype(np.float32)
    wh = rng.uniform(8, 60, (2, bs, nboxes)).astype(np.float32)
    images = rng.randint(0, 256, (bs, imgsz, imgsz, 3)).astype(np.uint8)
    labels = rng.randint(0, NC, (bs, nboxes)).astype(np.int32)
    boxes = np.stack([x1, y1, x1 + wh[0], y1 + wh[1]], axis=-1)
    mask = rng.uniform(size=(bs, nboxes)) < 0.4
    return images, labels, boxes, mask


def bench_train(variant: str = "yolov10s", imgsz: int = 640, batch_sizes=(32, 128), nboxes: int = 24,
                steps: int = 16, remat: str = "none", device: str = "cuda") -> dict:
    """{"best_ips", "best_bs", "per_bs": {bs: images/s}} over `batch_sizes`
    in order, up to the first that does not fit."""
    from ..engine.trainer import TrainConfig, Trainer

    check_device(device)
    results = {}
    best_ips, best_bs = 0.0, 0
    for bs in batch_sizes:
        images, labels, boxes, mask = synthetic_batch(bs, imgsz, nboxes)
        tr = batch = None
        try:
            cfg = TrainConfig(bf16=True, augment=True, grad_clip=1.0, steps_per_epoch=1000, remat=remat)
            tr = Trainer(build_model(variant), cfg, device=device)
            up = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
            batch = SimpleNamespace(images=up(images), gt_labels=up(labels), gt_boxes=up(boxes), gt_mask=mask)
            gen = torch.Generator(device=device).manual_seed(0)
            chain_s(lambda: tr.train_step(batch, gen), steps, device)  # warm-up
            gen = torch.Generator(device=device).manual_seed(7)
            losses = {}
            dt = chain_s(lambda: losses.update(tr.train_step(batch, gen)), steps, device)
            fits = True
        except torch.OutOfMemoryError:
            fits = False
        if not fits:  # outside the handler, whose traceback holds the failed step's tensors
            tr = batch = None
            free_device(f"{variant} train", bs)
            break
        assert bool(torch.isfinite(losses["total"]))
        ips = steps * bs / dt
        results[bs] = ips
        if ips > best_ips:
            best_ips, best_bs = ips, bs
        tr = batch = None
        free_device()
    return {"best_ips": best_ips, "best_bs": best_bs, "per_bs": results}


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="leanyolo_tpu_torch training benchmark")
    p.add_argument("--variant", default="yolov10s")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch-sizes", default="32,128")
    p.add_argument("--nboxes", type=int, default=24)
    p.add_argument("--steps", type=int, default=16, help="warm-up steps, then as many timed steps")
    p.add_argument("--remat", choices=["none", "full"], default="none",
                   help="checkpoint the forward node by node (the backward recomputes it)")
    p.add_argument("--device", default="cuda", help="where the model trains: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    check_device(args.device)
    r = bench_train(args.variant, args.imgsz, tuple(int(b) for b in args.batch_sizes.split(",")), args.nboxes,
                    args.steps, remat=args.remat, device=args.device)
    print(json.dumps({
        "metric": f"{args.variant}_{args.imgsz}_bf16_train_images_per_sec_per_chip",
        "value": round(r["best_ips"], 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(r["best_ips"] / 1.0, 2),
        "detail": {"batch_size": r["best_bs"], "per_batch_size": {str(k): round(v, 2) for k, v in r["per_bs"].items()},
                   **device_detail(args.device)},
    }))


if __name__ == "__main__":
    main()
