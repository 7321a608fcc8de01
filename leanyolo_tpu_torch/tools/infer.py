"""Inference CLI: detections per box on stdout and drawn images in --save-dir.

Counterpart of the JAX package's `tools/infer.py`: `--decode topk` runs the NMS-free one2one branch, `--decode nms` the
one2many branch with --conf and --iou; images letterbox on the host
(--preprocess host, cv2's pixels) or on the device (--preprocess device).
Runs on the card unless --device names another.

--spatial-parallel S runs each image across the S processes of the job, one
card each, on a (1, S) space mesh (each holds a band of the image's rows):
start it with `torchrun --nproc-per-node=S` or one launch a process with
the LEANYOLO_* variables. Process 0 prints and draws.

Example:
    python -m leanyolo_tpu_torch.tools.infer --source dog.jpg --model yolov10s \\
        --weights PRETRAINED_COCO --imgsz 640 --decode topk
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import List, Optional, Sequence

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="leanyolo_tpu_torch inference")
    p.add_argument("--source", required=True, help="image file or directory")
    p.add_argument("--model", default="yolov10s")
    p.add_argument("--weights", default="PRETRAINED_COCO", help="'PRETRAINED_COCO', checkpoint path, or 'none'")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--decode", choices=["topk", "nms"], default="topk")
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--dtype", choices=["float32", "bf16"], default="float32")
    p.add_argument("--save-dir", default="runs/infer")
    p.add_argument("--class-names", default=None, help="comma-separated; default COCO-80")
    p.add_argument("--classes-ann", default=None,
                   help="COCO-style annotations JSON to derive class names from; --class-names wins if both given")
    p.add_argument("--preprocess", choices=["host", "device"], default="host",
                   help="'host': the numpy letterbox per image (cv2's pixels); 'device': the letterbox warped on "
                   "the predictor's device")
    p.add_argument(
        "--spatial-parallel", type=int, default=0, metavar="S",
        help="latency mode: run EACH image across S processes, one card each, by splitting its height over a "
        "(1, S) mesh (halo exchanges between neighbouring bands)",
    )
    p.add_argument("--device", default="cuda", help="where the model runs: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def list_images(source: str) -> List[Path]:
    """A file, or a directory's images by extension, sorted by path."""
    path = Path(source)
    if path.is_dir():
        return sorted(p for p in path.iterdir() if p.suffix.lower() in IMAGE_EXTS)
    if path.is_file():
        return [path]
    raise FileNotFoundError(source)


def class_names_of(args: argparse.Namespace) -> List[str]:
    """--class-names, else the categories of --classes-ann by id, else COCO-80."""
    if args.class_names:
        return args.class_names.split(",")
    if args.classes_ann:
        with open(args.classes_ann, "r", encoding="utf-8") as f:
            cats = json.load(f).get("categories", [])
        return [c.get("name", str(i)) for i, c in enumerate(sorted(cats, key=lambda c: c.get("id", 0)))]
    from ..data.coco import coco80_class_names

    return coco80_class_names()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    mesh, pid = None, 0
    if args.spatial_parallel:
        from ..parallel.distributed import cli_distributed_setup
        from ..parallel.mesh import make_sp_mesh

        _, pid = cli_distributed_setup(device=args.device)
        try:
            mesh = make_sp_mesh(1, args.spatial_parallel, device=args.device)
        except ValueError as e:
            raise SystemExit(f"--spatial-parallel {args.spatial_parallel}: {e}") from None

    from ..data.dataset import read_rgb
    from ..engine.predictor import Predictor
    from ..models.registry import get_model
    from ..utils.viz import draw_detections, save_image

    class_names = class_names_of(args)
    weights = None if args.weights in ("none", "None", "") else args.weights
    model = get_model(args.model, weights=weights, class_names=class_names)
    predictor = Predictor(model, imgsz=args.imgsz, decode=args.decode, conf_thresh=args.conf, iou_thresh=args.iou,
                          max_det=args.max_det, dtype=args.dtype, device=args.device, mesh=mesh)

    paths = list_images(args.source)
    if pid == 0:
        os.makedirs(args.save_dir, exist_ok=True)
    for path in paths:
        try:
            rgb = read_rgb(str(path))
        except OSError:
            if pid == 0:
                print(f"skip unreadable image: {path}")
            continue
        dets = predictor.predict_images([rgb], preprocess=args.preprocess)[0]
        if pid:
            continue  # process 0 reports
        for d in dets:
            x1, y1, x2, y2, score, cls = d[:6]
            name = class_names[int(cls)] if int(cls) < len(class_names) else str(int(cls))
            print(f"{path.name}: {name} ({int(cls)}) {score:.3f} [{x1:.1f}, {y1:.1f}, {x2:.1f}, {y2:.1f}]")
        out_path = os.path.join(args.save_dir, path.name)
        save_image(out_path, draw_detections(rgb, dets, class_names))
        print(f"saved: {out_path} ({len(dets)} detections)")


if __name__ == "__main__":
    main()
