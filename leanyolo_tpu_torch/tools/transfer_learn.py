"""Transfer-learning CLI: pretrained weights, head reset, backbone+neck frozen
then unfrozen, bf16, augmentation, a COCO evaluation each epoch.

Counterpart of the JAX package's `tools/transfer_learn.py`: a backbone lr
multiplier (0.1), warmup then cosine,
grad clip 1.0, bf16 activations unless --no-amp, hflip and brightness/
contrast unless --no-augment, the backbone and neck frozen until
--unfreeze-epoch, `best.npz` by mAP50-95, `epochNNN.npz` and `ckpt.npz`,
and `train.log` beside the stream log with the JAX CLI's lines;
--viz-interval N saves every N steps the current weights' detections on the
batch's first image to <out-dir>/viz/stepNNNNNN.jpg. A local
weights file loads leniently (`load_checkpoint_transfer`: a pretraining
run's class count need not match); anything else goes through `get_model`.
Runs on the card unless --device names another. --data-parallel and
--distributed run one process a card as the train CLI does (its
`parallel_setup`, `shard_dataset`): --batch-size is the global batch, and
evaluation, checkpoints, viz snapshots and `train.log` come from process 0.

Example:
    python -m leanyolo_tpu_torch.tools.transfer_learn --weights pretrain/ckpt.npz \\
        --train-images d/train --train-ann d/train/ann.json --val-images d/valid --val-ann d/valid/ann.json
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from ..parallel.distributed import add_distributed_args

    p = argparse.ArgumentParser(description="leanyolo_tpu_torch transfer learning")
    p.add_argument("--model", default="yolov10s")
    p.add_argument("--weights", default="PRETRAINED_COCO")
    p.add_argument("--train-images", required=True)
    p.add_argument("--train-ann", required=True)
    p.add_argument("--val-images", required=True)
    p.add_argument("--val-ann", required=True)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--bb-lr-mult", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--warmup-epochs", type=int, default=2)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--unfreeze-epoch", type=int, default=5)
    p.add_argument("--no-freeze-backbone", action="store_true")
    p.add_argument("--no-head-reset", action="store_true")
    p.add_argument("--no-amp", action="store_true", help="disable bf16 compute")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--max-boxes", type=int, default=128)
    p.add_argument(
        "--preprocess", choices=["host", "device"], default="host",
        help="'device' runs the letterbox warp and the GT-box map in the train step (the host only decodes "
        "and copies)",
    )
    p.add_argument("--max-images", type=int, default=None, help="train on the first N images")
    p.add_argument("--max-val-images", type=int, default=None, help="evaluate on the first N images")
    p.add_argument("--eval-every", type=int, default=1, help="evaluate every N epochs")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--eval-conf", type=float, default=0.001, help="per-epoch eval score threshold")
    p.add_argument("--eval-iou", type=float, default=0.65, help="per-epoch eval NMS IoU")
    p.add_argument(
        "--viz-interval", type=int, default=0,
        help="every N steps, decode the current weights on the first train image and save an annotated snapshot "
        "to <out-dir>/viz (0 = off)",
    )
    p.add_argument(
        "--viz-conf", type=float, default=0.25,
        help="score threshold for train-viz snapshots (the per-epoch eval's --eval-conf defaults to the mAP "
        "convention 0.001, so viz has its own)",
    )
    p.add_argument("--data-parallel", action="store_true")
    add_distributed_args(p, batch_semantics="--batch-size is the GLOBAL batch (divided across processes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default="runs/transfer")
    p.add_argument("--device", default="cuda", help="where to train: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def setup_logger(out_dir: Path, *, file: bool = True) -> logging.Logger:
    """`train.log` in out_dir (file=True) plus the stream, one format for
    both; file=False for processes other than 0, which must not append to a
    shared out-dir's log."""
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger("transfer")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(message)s")
    for h in ((logging.FileHandler(out_dir / "train.log"),) if file else ()) + (logging.StreamHandler(),):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from .train import parallel_setup, shard_dataset

    nprocs, pid, mesh = parallel_setup(args)

    import numpy as np
    import torch

    from ..data.dataset import CocoDetection, DataLoader, DeviceBatch
    from ..engine.predictor import Predictor
    from ..engine.trainer import TrainConfig, Trainer
    from ..engine.validator import validate_coco
    from ..models.registry import get_model, load_checkpoint_transfer, save_checkpoint
    from ..models.yolov10.model import reset_head
    from ..parallel.distributed import proc0_local_eval
    from ..utils.viz import draw_detections, save_image

    out_dir = Path(args.out_dir)
    log = setup_logger(out_dir, file=pid == 0)
    log.info(f"RUN START args={vars(args)}")

    with open(args.train_ann, "r", encoding="utf-8") as f:
        cats = json.load(f)["categories"]
    class_names = [c["name"] for c in sorted(cats, key=lambda c: c["id"])]
    log.info(f"classes: {class_names}")

    weights = None if args.weights in (None, "none", "None", "") else args.weights
    if weights is not None and Path(weights).is_file():
        # Lenient: the class-dependent head leaves of another class count
        # keep their fresh init (and the head is reset below anyway).
        model = get_model(args.model, weights=None, class_names=class_names, seed=args.seed)
        stats = load_checkpoint_transfer(model, weights)
        log.info(f"transfer init from {weights}: {stats['loaded']}/{stats['total']} leaves loaded, "
                 f"{len(stats['skipped'])} shape-mismatched kept fresh")
    else:
        model = get_model(args.model, weights=weights, class_names=class_names, seed=args.seed)
    if not args.no_head_reset:
        reset_head(model, args.seed)
        log.info("head reset to fresh random init")

    ds = CocoDetection(args.train_images, args.train_ann, img_size=args.imgsz, max_images=args.max_images,
                       preprocess=args.preprocess)
    local_bs = shard_dataset(ds, args, nprocs, pid)
    loader = DataLoader(ds, batch_size=local_bs, shuffle=True, max_boxes=args.max_boxes,
                        workers=args.workers, seed=args.seed)
    steps_per_epoch = max(1, len(loader))
    if mesh is not None:
        log.info(f"data-parallel over {dict(zip(mesh.mesh_dim_names, mesh.shape))} processes ({args.device})")

    cfg = TrainConfig(
        lr=args.lr,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        warmup_epochs=args.warmup_epochs,
        bb_lr_mult=args.bb_lr_mult,
        freeze_backbone=not args.no_freeze_backbone,
        unfreeze_epoch=args.unfreeze_epoch,
        grad_clip=args.grad_clip,
        bf16=not args.no_amp,
        augment=not args.no_augment,
        steps_per_epoch=steps_per_epoch,
        device_preprocess=args.preprocess == "device",
        imgsz=args.imgsz,
    )
    trainer = Trainer(model, cfg, mesh=mesh, device=args.device)
    gen = torch.Generator(device=trainer.device).manual_seed(args.seed)
    eval_predictor = None
    if mesh is None:
        eval_predictor = Predictor(model, imgsz=args.imgsz, decode="topk", conf_thresh=args.eval_conf,
                                   iou_thresh=args.eval_iou, device=trainer.device)

    def save_train_viz(batch) -> None:
        """The current weights' detections on the batch's first image: a host
        batch's letterboxed image through run_batch; a device batch's raw
        image, cropped from its canvas, through predict_images (boxes in its
        own coordinates)."""
        nonlocal eval_predictor
        if mesh is not None:  # process 0's own predictor, made at the first snapshot
            _, eval_predictor = proc0_local_eval(model, eval_predictor, imgsz=args.imgsz,
                                                 conf_thresh=args.eval_conf, device=trainer.device)
        else:
            eval_predictor.update_params(model)
        if isinstance(batch, DeviceBatch):
            h, w = (int(v) for v in batch.hw[0])
            src = np.ascontiguousarray(batch.canvas[0, :h, :w], np.uint8)
            d = eval_predictor.predict_images([src])[0]
        else:
            dets, _ = eval_predictor.run_batch(batch.images[:1])
            d = dets[0].cpu().numpy()
            src = np.asarray(batch.images[0], np.uint8)
        d = d[d[:, 4] > args.viz_conf]
        viz_dir = out_dir / "viz"
        viz_dir.mkdir(parents=True, exist_ok=True)
        path = str(viz_dir / f"step{trainer.global_step:06d}.jpg")
        save_image(path, draw_detections(src, d, class_names))
        log.info(f"[viz] saved: {path}")

    best_map = -1.0
    for epoch in range(args.epochs):
        if cfg.freeze_backbone and epoch == args.unfreeze_epoch:
            log.info(f"UNFREEZE backbone at epoch {epoch + 1}")
        t0 = time.perf_counter()
        last = None
        for batch in loader:
            last = trainer.train_step(batch, gen)
            if args.viz_interval and pid == 0 and trainer.global_step % args.viz_interval == 0:
                save_train_viz(batch)
        running = {k: (float(last[k]) if last is not None else 0.0) for k in ("total", "cls", "reg")}
        dt = time.perf_counter() - t0
        log.info(f"EPOCH {epoch + 1}/{args.epochs} loss={running['total']:.4f} "
                 f"cls={running['cls']:.4f} reg={running['reg']:.4f} time={dt:.1f}s")

        if pid == 0 and (epoch + 1) % max(1, args.eval_every) == 0:
            try:
                eval_model = model
                if mesh is not None:
                    eval_model, eval_predictor = proc0_local_eval(model, eval_predictor, imgsz=args.imgsz,
                                                                  conf_thresh=args.eval_conf, device=trainer.device)
                stats = validate_coco(eval_model, images_dir=args.val_images, ann_json=args.val_ann,
                                      imgsz=args.imgsz, batch_size=local_bs, decode="topk",
                                      conf_thresh=args.eval_conf, iou_thresh=args.eval_iou,
                                      max_images=args.max_val_images, workers=args.workers,
                                      predictor=eval_predictor)
                log.info(f"VAL epoch {epoch + 1} mAP50-95={stats['map_50_95']:.5f} mAP50={stats['map_50']:.5f}")
                if stats["map_50_95"] > best_map:
                    best_map = stats["map_50_95"]
                    save_checkpoint(model, str(out_dir / "best.npz"),
                                    extra_meta={"epoch": epoch + 1, "map_50_95": best_map})
            except Exception as e:  # a failed evaluation does not stop training, as in the JAX CLI
                log.info(f"VAL failed: {e}")

        if pid == 0:
            save_checkpoint(model, str(out_dir / f"epoch{epoch + 1:03d}.npz"), extra_meta={"epoch": epoch + 1})

    if pid == 0:
        save_checkpoint(model, str(out_dir / "ckpt.npz"))
    log.info(f"RUN END best mAP50-95={best_map:.5f}")


if __name__ == "__main__":
    main()
