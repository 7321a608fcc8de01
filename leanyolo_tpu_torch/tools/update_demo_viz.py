"""Regenerate the demo visualization image: inference on a demo image (or
on a synthetic scene) and the drawn result.

Counterpart of the JAX package's `tools/update_demo_viz.py`: without
--source the scene is 480x640 gray (180) with six filled rectangles of
random colours from `np.random.RandomState(0)`, drawn as cv2.rectangle
fills them (the scene is built in BGR, as JAX's, and turned to RGB). Runs
on the card unless --device names another.

Example:
    python -m leanyolo_tpu_torch.tools.update_demo_viz --model yolov10s --out demo_viz.jpg
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="update demo viz image")
    p.add_argument("--source", default=None, help="input image (default: synthetic demo scene)")
    p.add_argument("--model", default="yolov10s")
    p.add_argument("--weights", default="PRETRAINED_COCO")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--out", default="demo_viz.jpg")
    p.add_argument("--device", default="cuda", help="where the model runs: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def synthetic_scene() -> np.ndarray:
    """The JAX CLI's demo scene, RGB: six rectangles on gray, RandomState(0)."""
    from ..utils.viz import fill_rect

    rng = np.random.RandomState(0)
    bgr = np.full((480, 640, 3), 180, np.uint8)
    for _ in range(6):
        x, y = rng.randint(0, 500), rng.randint(0, 340)
        p2 = (x + rng.randint(40, 140), y + rng.randint(40, 140))
        fill_rect(bgr, (x, y), p2, tuple(int(c) for c in rng.randint(0, 255, 3)))
    return np.ascontiguousarray(bgr[..., ::-1])


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)

    from ..data.coco import coco80_class_names
    from ..data.dataset import read_rgb
    from ..engine.predictor import Predictor
    from ..models.registry import get_model
    from ..utils.viz import draw_detections, save_image

    if args.source:
        try:
            rgb = read_rgb(args.source)
        except OSError:
            raise SystemExit(f"unreadable image: {args.source}")
    else:
        rgb = synthetic_scene()
    weights = None if args.weights in ("none", "None", "") else args.weights
    model = get_model(args.model, weights=weights, class_names=coco80_class_names())
    pred = Predictor(model, imgsz=args.imgsz, decode="topk", conf_thresh=args.conf, device=args.device)
    dets = pred.predict_images([rgb])[0]
    save_image(args.out, draw_detections(rgb, dets, coco80_class_names()))
    print(f"wrote {args.out} ({len(dets)} detections)")


if __name__ == "__main__":
    main()
