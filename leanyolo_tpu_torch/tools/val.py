"""COCO validation CLI: a model from `get_model`, `validate_coco`, the mAP
line and a row of the 27-column CSV run log.

Counterpart of the JAX package's `tools/val.py`; --viz-dir draws the
detections (letterboxed pixels under the host letterbox, original images
under --preprocess device). Dataset resolution: --images-dir and --ann-json,
else <data-root>/annotations.json with <data-root>/images; COCO val2017 is
not downloaded. Runs on the card unless --device names another.

Data parallel, one process a card: --data-parallel N splits each batch of
--batch-size over the N processes of a torchrun launch (every process scores
all of it); --distributed gives each process a stride shard of the image list,
evaluated on its own card with a per-process --batch-size, merged by one
allgather (every process reports the global mAP). The CSV row, saved
detections and drawings come from process 0.

Spatial and tensor parallelism: --spatial-parallel S (or --tensor-parallel
M) with --data-parallel N runs in a job of N*S (N*M) processes, one card
each, on a (data, space) or (data, model) mesh: each batch of --batch-size
splits over the N data processes, and each image's rows over S (each
layer's output channels over M). Start it with torchrun
(`torchrun --nproc-per-node=<N*S> -m leanyolo_tpu_torch.tools.val
--data-parallel N --spatial-parallel S ...`) or one launch a process with
LEANYOLO_COORDINATOR / LEANYOLO_NUM_PROCS / LEANYOLO_PROC_ID. Neither
composes with --distributed, and the two are mutually exclusive.

Example:
    python -m leanyolo_tpu_torch.tools.val --model yolov10s --weights PRETRAINED_COCO \\
        --data-root datasets/coco --imgsz 640 --decode topk
"""

from __future__ import annotations

import argparse
import json
import uuid
from pathlib import Path
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from ..parallel.distributed import add_distributed_args

    p = argparse.ArgumentParser(description="leanyolo_tpu_torch COCO validation")
    p.add_argument("--model", default="yolov10s")
    p.add_argument("--weights", default="PRETRAINED_COCO")
    p.add_argument("--data-root", default="datasets/coco")
    p.add_argument("--images-dir", default=None)
    p.add_argument("--ann-json", default=None)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--decode", choices=["topk", "nms"], default="topk")
    p.add_argument("--conf", type=float, default=0.001)
    p.add_argument("--iou", type=float, default=0.65)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--class-wise-nms", action="store_true", help="per-class NMS (offset trick)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--dtype", choices=["float32", "bf16"], default="float32")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--save-detections", default=None)
    p.add_argument(
        "--viz-dir", default=None,
        help="save annotated images here (letterboxed pixels under host preprocessing; original images with "
        "unletterboxed boxes under --preprocess device)",
    )
    p.add_argument("--viz-conf", type=float, default=0.25)
    p.add_argument("--viz-name-mode", choices=["file", "id", "index"], default="file")
    p.add_argument("--measure-fps", action="store_true")
    p.add_argument("--warmup-iters", type=int, default=1, help="warm-up calls before the FPS measurement")
    p.add_argument(
        "--preprocess", choices=["host", "device"], default="host",
        help="'device' letterboxes on the predictor's device (fixed canvas + bilinear warp)",
    )
    p.add_argument(
        "--data-parallel", type=int, default=0, metavar="N",
        help="shard eval batches over N processes, one card each (torchrun --nproc-per-node=N; 0 = one process)",
    )
    p.add_argument(
        "--spatial-parallel", type=int, default=0, metavar="S",
        help="shard image HEIGHT over S processes, one card each; composes with --data-parallel into a "
        "(data, space) mesh of N*S processes (latency mode: --data-parallel 1 --spatial-parallel S)",
    )
    p.add_argument(
        "--tensor-parallel", type=int, default=0, metavar="M",
        help="shard conv filters (output channels) over M processes, one card each; composes with "
        "--data-parallel into a (data, model) mesh of N*M processes",
    )
    add_distributed_args(
        p,
        batch_semantics="NOTE: --batch-size is PER-PROCESS here (sharded "
        "eval has no cross-host step), unlike the trainer CLIs where it is "
        "the global batch; detections merge via one allgather and every "
        "process reports the global mAP",
    )
    p.add_argument("--device", default="cuda", help="where the model runs: 'cuda' (default) or 'cpu'")
    p.add_argument("--log-csv", default="runs/val_log.csv")
    p.add_argument("--notes", default="")
    p.add_argument("--run-id", default=None, help="CSV run identifier override")
    return p.parse_args(argv)


def resolve_dataset(args: argparse.Namespace):
    """Explicit dirs -> <root>/annotations.json subset; exits where COCO
    val2017 would have to be downloaded."""
    if args.images_dir and args.ann_json:
        return args.images_dir, args.ann_json
    root = Path(args.data_root)
    subset_ann = root / "annotations.json"
    if subset_ann.exists():
        images_dir = root / "images" if (root / "images").is_dir() else root
        return str(images_dir), str(subset_ann)
    raise SystemExit(f"no annotations under {root} (expected {subset_ann}, or --images-dir and --ann-json); "
                     "downloading COCO val2017 is not ported")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from ..parallel.mesh import make_mesh, make_sp_mesh, make_tp_mesh

    if args.spatial_parallel and args.tensor_parallel:
        raise SystemExit("--spatial-parallel and --tensor-parallel are mutually exclusive")
    second = args.spatial_parallel or args.tensor_parallel
    nprocs, pid = 1, 0
    if args.distributed or args.data_parallel or second:
        from ..parallel.distributed import cli_distributed_setup

        nprocs, pid = cli_distributed_setup(args.coordinator, args.num_processes, args.process_id,
                                            device=args.device)
    sharded = args.distributed and nprocs > 1
    mesh = None
    if second:
        if sharded:
            raise SystemExit("--spatial/tensor-parallel do not compose with --distributed")
        n_data = args.data_parallel or 1
        if args.batch_size % n_data:
            raise SystemExit("--batch-size must be divisible by --data-parallel")
        make, flag = (make_sp_mesh, "spatial") if args.spatial_parallel else (make_tp_mesh, "tensor")
        try:
            mesh = make(n_data, second, device=args.device)
        except ValueError as e:
            raise SystemExit(f"--data-parallel {n_data} x --{flag}-parallel {second}: {e}") from None
    elif args.data_parallel:
        if args.data_parallel != nprocs:
            raise SystemExit(f"--data-parallel {args.data_parallel} needs as many processes, one a card "
                             f"(torchrun --nproc-per-node={args.data_parallel}); the job has {nprocs}")
        # Under --distributed each process evaluates its shard alone: a mesh of this process.
        mesh = make_mesh(local=sharded, device=args.device)
        if not sharded and args.batch_size % args.data_parallel:
            raise SystemExit("--batch-size must be divisible by --data-parallel")

    images_dir, ann_json = resolve_dataset(args)

    from ..engine.validator import validate_coco
    from ..models.registry import get_model
    from ..utils.val_log import append_row, collect_env_info, now_iso

    with open(ann_json, "r", encoding="utf-8") as f:
        cats = json.load(f)["categories"]
    class_names = [c["name"] for c in sorted(cats, key=lambda c: c["id"])]

    weights = None if args.weights in ("none", "None", "") else args.weights
    model = get_model(args.model, weights=weights, class_names=class_names)

    stats = validate_coco(
        model,
        images_dir=images_dir,
        ann_json=ann_json,
        imgsz=args.imgsz,
        batch_size=args.batch_size,
        decode=args.decode,
        conf_thresh=args.conf,
        iou_thresh=args.iou,
        max_det=args.max_det,
        max_images=args.max_images,
        dtype=args.dtype,
        workers=args.workers,
        class_wise_nms=args.class_wise_nms,
        save_detections=args.save_detections if pid == 0 else None,
        measure_speed=args.measure_fps,
        fps_warmup=args.warmup_iters,
        viz_dir=args.viz_dir if pid == 0 else None,
        viz_conf=args.viz_conf,
        viz_name_mode=args.viz_name_mode,
        preprocess=args.preprocess,
        device=args.device,
        mesh=mesh,
        shard=(pid, nprocs) if sharded else None,
    )
    print(
        f"mAP50-95={stats['map_50_95']:.5f} mAP50={stats['map_50']:.5f} "
        f"mAP75={stats['map_75']:.5f} images={stats['n_images']} "
        f"throughput={stats['throughput_ips']:.1f} img/s"
        + (f" fps={stats['fps']:.1f}" if "fps" in stats else "")
    )

    if pid != 0:
        return  # the CSV row is process 0's
    append_row(
        Path(args.log_csv),
        {
            "timestamp": now_iso(),
            "run_id": args.run_id or uuid.uuid4().hex[:8],
            **collect_env_info(device=args.device),
            "runtime": "torch",
            "precision": "bf16" if args.dtype == "bf16" else "fp32",
            "model": args.model,
            "weights": args.weights,
            "dataset": "coco",
            "images_dir": images_dir,
            "ann_json": ann_json,
            "split": "val2017",
            "n_images": stats["n_images"],
            "imgsz": args.imgsz,
            "conf": args.conf,
            "iou": args.iou,
            "max_images": args.max_images or "",
            "map_50_95": f"{stats['map_50_95']:.5f}",
            "map_50": f"{stats['map_50']:.5f}",
            "map_75": f"{stats['map_75']:.5f}",
            "fps": f"{stats['fps']:.1f}" if "fps" in stats else "",
            "detections_json": args.save_detections or "",
            "viz_dir": args.viz_dir or "",
            "notes": args.notes,
        },
    )
    print(f"logged: {args.log_csv}")


if __name__ == "__main__":
    main()
