"""Training CLI: COCO-format data, AdamW + warmup-cosine, a COCO evaluation
and checkpoints each epoch.

Counterpart of the JAX package's `tools/train.py`: the same flags
(--freeze-backbone freezes the neck too, for the whole run; --head-reset),
`history.jsonl` with one row an epoch, `epochNNN.npz`, `last.npz` and
`ckpt.npz` with the same metadata, and an exact --resume: the model and
optimizer state, the step counter, the shuffle order and the augmentation
stream (a generator seeded from (seed, step)) all restore. Runs on the card
unless --device names another.

Data parallel, one process a card: --data-parallel over the processes of a
torchrun launch (a world of one without it), --distributed across nodes
(--coordinator, --num-processes, --process-id, or LEANYOLO_* / torchrun's
environment) on a (dcn, data) mesh. --batch-size is the global batch; each
process loads its shard of the image list (`shard_image_list`) and steps on
its rows; evaluation, checkpoints, history.jsonl and the logs come from
process 0, which also evaluates with a predictor of its own.

Example:
    python -m leanyolo_tpu_torch.tools.train --train-images d/train --train-ann d/train/ann.json \\
        --val-images d/valid --val-ann d/valid/ann.json --epochs 10 --bf16 --augment
    torchrun --nproc-per-node=8 -m leanyolo_tpu_torch.tools.train --data-parallel --batch-size 256 ...
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from ..parallel.distributed import add_distributed_args

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
    p.add_argument("--data-parallel", action="store_true")
    add_distributed_args(
        p,
        batch_semantics="--batch-size is the GLOBAL batch (divided across processes)",
    )
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


def parallel_setup(args: argparse.Namespace):
    """Join the job for --distributed or --data-parallel and return
    (nprocs, pid, mesh): a (dcn, data) mesh for --distributed, a flat one for
    --data-parallel, None without either."""
    from ..parallel import distributed as D
    from ..parallel.mesh import make_hybrid_mesh, make_mesh

    if not (args.distributed or args.data_parallel):
        return 1, 0, None
    if args.distributed:
        nprocs, pid = D.cli_distributed_setup(args.coordinator, args.num_processes, args.process_id,
                                              device=args.device)
        mesh = make_hybrid_mesh(device=args.device)
    else:
        nprocs, pid = D.cli_distributed_setup(device=args.device)
        mesh = make_mesh(device=args.device)
    return nprocs, pid, mesh


def shard_dataset(ds, args: argparse.Namespace, nprocs: int, pid: int) -> int:
    """This process's shard of the image list (equal lengths); returns the
    per-process batch size. Exits where the global batch does not divide."""
    if args.batch_size % nprocs:
        raise SystemExit(f"--batch-size (global) must be divisible by {nprocs} processes")
    if nprocs > 1:
        from ..parallel.distributed import shard_image_list

        try:
            ds.images = shard_image_list(ds.images, pid, nprocs)
        except ValueError as e:
            raise SystemExit(str(e))
    return args.batch_size // nprocs


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    nprocs, pid, mesh = parallel_setup(args)

    import numpy as np

    from ..data.dataset import CocoDetection, DataLoader
    from ..engine.predictor import Predictor
    from ..engine.trainer import TrainConfig, Trainer
    from ..engine.validator import validate_coco
    from ..models.registry import get_model, load_checkpoint_into, save_checkpoint
    from ..models.yolov10.model import reset_head
    from ..parallel.distributed import allgather_obj, proc0_local_eval

    if mesh is not None:
        print(f"data-parallel: process {pid}/{nprocs}, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
              f"{args.device}", flush=True)

    with open(args.train_ann, "r", encoding="utf-8") as f:
        cats = json.load(f)["categories"]
    class_names = [c["name"] for c in sorted(cats, key=lambda c: c["id"])]

    weights = None if args.weights in (None, "none", "None", "") else args.weights
    model = get_model(args.model, weights=weights, class_names=class_names, seed=args.seed)
    if args.head_reset:
        reset_head(model, args.seed)

    ds = CocoDetection(args.train_images, args.train_ann, img_size=args.imgsz, max_images=args.max_images,
                       preprocess=args.preprocess)
    local_bs = shard_dataset(ds, args, nprocs, pid)
    loader = DataLoader(ds, batch_size=local_bs, shuffle=True, max_boxes=args.max_boxes,
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
    trainer = Trainer(model, cfg, mesh=mesh, device=args.device)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    start_epoch = 0
    if args.resume:
        last_ckpt, state_ckpt = out_dir / "last.npz", out_dir / "train_state.pt"
        # Process 0 writes them, so every process must see them (a shared
        # --out-dir); all agree before any exits.
        if not all(allgather_obj(last_ckpt.exists() and state_ckpt.exists())):
            raise SystemExit(f"--resume: {last_ckpt} / {state_ckpt} not found"
                             + (" on every process (process 0 writes them: a shared --out-dir)" if nprocs > 1 else ""))
        load_checkpoint_into(model, str(last_ckpt))
        trainer.load_train_state(str(state_ckpt))
        start_epoch = trainer.global_step // steps_per_epoch
        print(f"resumed from {out_dir} at epoch {start_epoch} (step {trainer.global_step})")

    # One row an epoch; a fresh run truncates, --resume appends.
    history_path = out_dir / "history.jsonl"
    if pid == 0 and not args.resume and history_path.exists():
        history_path.unlink()

    eval_predictor = None
    if args.val_images and args.val_ann and mesh is None:
        # One predictor for every epoch's evaluation (fp32, unfolded, top-k);
        # on a mesh process 0 makes its own (proc0_local_eval).
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

        if args.val_images and args.val_ann and (epoch + 1) % args.eval_every == 0 and pid == 0:
            try:
                eval_model = model
                if mesh is not None:
                    eval_model, eval_predictor = proc0_local_eval(model, eval_predictor, imgsz=args.imgsz,
                                                                  conf_thresh=args.eval_conf, device=trainer.device)
                stats = validate_coco(eval_model, images_dir=args.val_images, ann_json=args.val_ann,
                                      imgsz=args.imgsz, batch_size=local_bs, decode="topk",
                                      conf_thresh=args.eval_conf, iou_thresh=args.eval_iou, workers=args.workers,
                                      predictor=eval_predictor)
                print(f"epoch {epoch + 1} mAP50-95={stats['map_50_95']:.5f} mAP50={stats['map_50']:.5f}")
                epoch_row["map_50_95"] = round(stats["map_50_95"], 5)
                epoch_row["map_50"] = round(stats["map_50"], 5)
            except Exception as e:  # a failed evaluation does not stop training, as in the JAX CLI
                print(f"eval failed: {e}")

        if pid == 0:
            with open(history_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(epoch_row) + "\n")
            save_checkpoint(model, str(out_dir / f"epoch{epoch + 1:03d}.npz"), extra_meta={"epoch": epoch + 1})
            save_checkpoint(model, str(out_dir / "last.npz"), extra_meta={"epoch": epoch + 1})
            trainer.save_train_state(str(out_dir / "train_state.pt"))

    if pid == 0:
        save_checkpoint(model, str(out_dir / "ckpt.npz"))
        print(f"saved final checkpoint: {out_dir / 'ckpt.npz'}")


if __name__ == "__main__":
    main()
