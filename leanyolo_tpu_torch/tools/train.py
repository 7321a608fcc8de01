"""Training CLI: COCO-format data, AdamW + warmup-cosine, a COCO evaluation
and checkpoints each epoch.

Counterpart of the JAX package's `tools/train.py` without its data-parallel
and distributed options: the same flags (--freeze-backbone freezes the neck
too, for the whole run; --head-reset), `history.jsonl` with one row an
epoch, `epochNNN.npz`, `last.npz` and `ckpt.npz` with the same metadata, and
an exact --resume: the model and optimizer state, the step counter, the
shuffle order and the augmentation stream (a generator seeded from
(seed, step)) all restore. Runs on the card unless --device names another.

Example:
    python -m leanyolo_tpu_torch.tools.train --train-images d/train --train-ann d/train/ann.json \\
        --val-images d/valid --val-ann d/valid/ann.json --epochs 10 --bf16 --augment
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="leanyolo_tpu_torch baseline trainer")
    p.add_argument("--model", default="yolov10s")
    p.add_argument("--weights", default=None, help="'PRETRAINED_COCO', a checkpoint path, or none")
    p.add_argument("--train-images", required=True)
    p.add_argument("--train-ann", required=True)
    p.add_argument("--val-images", default=None)
    p.add_argument("--val-ann", default=None)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--warmup-epochs", type=int, default=1)
    p.add_argument("--grad-clip", type=float, default=0.0)
    p.add_argument("--freeze-backbone", action="store_true", help="freeze backbone+neck")
    p.add_argument("--head-reset", action="store_true", help="re-init the head with fresh random weights")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--max-boxes", type=int, default=128)
    p.add_argument(
        "--preprocess", choices=["host", "device"], default="host",
        help="'host': letterbox each image on the CPU; 'device': raw pixels go on a fixed canvas and the "
        "letterbox warp and the GT-box map run in the train step",
    )
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default="runs/train")
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=10, help="print the losses every N steps")
    p.add_argument("--eval-conf", type=float, default=0.001, help="per-epoch eval score threshold")
    p.add_argument("--eval-iou", type=float, default=0.65, help="per-epoch eval NMS IoU (NMS decodes only)")
    p.add_argument(
        "--resume", action="store_true",
        help="resume from <out-dir>/last.npz + train_state.pt (exact: optimizer moments, step counter, "
        "augmentation stream and shuffle order all restore)",
    )
    p.add_argument("--device", default="cuda", help="where to train: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def step_generator(seed: int, step: int, device) -> "torch.Generator":
    """The augmentation generator of global step `step`: seeded from
    (seed, step), so a resumed run draws what an uninterrupted one drew."""
    import numpy as np
    import torch

    state = int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)

    import numpy as np

    from ..data.dataset import CocoDetection, DataLoader
    from ..engine.predictor import Predictor
    from ..engine.trainer import TrainConfig, Trainer
    from ..engine.validator import validate_coco
    from ..models.registry import get_model, load_checkpoint_into, save_checkpoint
    from ..models.yolov10.model import reset_head

    with open(args.train_ann, "r", encoding="utf-8") as f:
        cats = json.load(f)["categories"]
    class_names = [c["name"] for c in sorted(cats, key=lambda c: c["id"])]

    weights = None if args.weights in (None, "none", "None", "") else args.weights
    model = get_model(args.model, weights=weights, class_names=class_names, seed=args.seed)
    if args.head_reset:
        reset_head(model, args.seed)

    ds = CocoDetection(args.train_images, args.train_ann, img_size=args.imgsz, max_images=args.max_images,
                       preprocess=args.preprocess)
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True, max_boxes=args.max_boxes,
                        workers=args.workers, seed=args.seed)
    steps_per_epoch = max(1, len(loader))

    cfg = TrainConfig(
        lr=args.lr,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        warmup_epochs=args.warmup_epochs,
        freeze_backbone=args.freeze_backbone,
        unfreeze_epoch=args.epochs + 1 if args.freeze_backbone else 0,  # frozen for the whole run
        grad_clip=args.grad_clip,
        bf16=args.bf16,
        augment=args.augment,
        steps_per_epoch=steps_per_epoch,
        device_preprocess=args.preprocess == "device",
        imgsz=args.imgsz,
    )
    trainer = Trainer(model, cfg, device=args.device)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    start_epoch = 0
    if args.resume:
        last_ckpt, state_ckpt = out_dir / "last.npz", out_dir / "train_state.pt"
        if not (last_ckpt.exists() and state_ckpt.exists()):
            raise SystemExit(f"--resume: {last_ckpt} / {state_ckpt} not found")
        load_checkpoint_into(model, str(last_ckpt))
        trainer.load_train_state(str(state_ckpt))
        start_epoch = trainer.global_step // steps_per_epoch
        print(f"resumed from {out_dir} at epoch {start_epoch} (step {trainer.global_step})")

    # One row an epoch; a fresh run truncates, --resume appends.
    history_path = out_dir / "history.jsonl"
    if not args.resume and history_path.exists():
        history_path.unlink()

    eval_predictor = None
    if args.val_images and args.val_ann:
        # One predictor for every epoch's evaluation (fp32, unfolded, top-k).
        eval_predictor = Predictor(model, imgsz=args.imgsz, decode="topk", conf_thresh=args.eval_conf,
                                   iou_thresh=args.eval_iou, device=trainer.device)

    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        nb = 0
        ep_losses: List[dict] = []  # 0-d tensors on the device, read once an epoch
        loader.set_epoch(epoch)  # replay the epoch's shuffle order on resume
        for batch in loader:
            losses = trainer.train_step(batch, step_generator(args.seed, trainer.global_step, trainer.device))
            ep_losses.append(losses)
            nb += 1
            if nb % max(1, args.log_interval) == 0 or nb == steps_per_epoch:
                vals = {k: float(losses[k]) for k in ("total", "cls", "reg")}
                print(f"epoch {epoch + 1}/{args.epochs} step {nb}/{steps_per_epoch} "
                      f"total={vals['total']:.4f} cls={vals['cls']:.4f} reg={vals['reg']:.4f}", flush=True)
        epoch_row = {
            "epoch": epoch + 1,
            **{f"loss_{k}": float(np.mean([float(l[k]) for l in ep_losses])) for k in ("total", "cls", "reg")},
        }
        dt = time.perf_counter() - t0
        print(f"epoch {epoch + 1} done in {dt:.1f}s ({nb * args.batch_size / dt:.1f} img/s)", flush=True)
        epoch_row.update(steps=nb, time_s=round(dt, 2), img_s=round(nb * args.batch_size / dt, 2))

        if eval_predictor is not None and (epoch + 1) % args.eval_every == 0:
            try:
                stats = validate_coco(model, images_dir=args.val_images, ann_json=args.val_ann, imgsz=args.imgsz,
                                      batch_size=args.batch_size, decode="topk", conf_thresh=args.eval_conf,
                                      iou_thresh=args.eval_iou, workers=args.workers, predictor=eval_predictor)
                print(f"epoch {epoch + 1} mAP50-95={stats['map_50_95']:.5f} mAP50={stats['map_50']:.5f}")
                epoch_row["map_50_95"] = round(stats["map_50_95"], 5)
                epoch_row["map_50"] = round(stats["map_50"], 5)
            except Exception as e:  # a failed evaluation does not stop training, as in the JAX CLI
                print(f"eval failed: {e}")

        with open(history_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(epoch_row) + "\n")
        save_checkpoint(model, str(out_dir / f"epoch{epoch + 1:03d}.npz"), extra_meta={"epoch": epoch + 1})
        save_checkpoint(model, str(out_dir / "last.npz"), extra_meta={"epoch": epoch + 1})
        trainer.save_train_state(str(out_dir / "train_state.pt"))

    save_checkpoint(model, str(out_dir / "ckpt.npz"))
    print(f"saved final checkpoint: {out_dir / 'ckpt.npz'}")


if __name__ == "__main__":
    main()
