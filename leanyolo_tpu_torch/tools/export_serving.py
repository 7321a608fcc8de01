"""Serving export CLI: a `torch.export` artifact (`.pt2`) and its JSON
sidecar, or one artifact per size bucket and a manifest (--sizes).

Counterpart of the JAX package's `tools/export_serving.py`, flags and all,
plus --device. --validate reloads the artifact and runs it against the
live serving module on the same input (RandomState(0) pixels at batch 1):
`num_dets` must be equal and the detections bit-equal, as both run the
same kernels on the same device; bucketed, it serves two mixed-size images
through `BucketedServing` and holds each against the live module of its
bucket. The artifact loads where `leanyolo_tpu_torch.kernels` is imported
(`load_exported` does it). Runs on the card unless --device names another.

Example:
    python -m leanyolo_tpu_torch.tools.export_serving --model yolov10s --weights PRETRAINED_COCO \\
        --imgsz 640 --decode topk --out runs/export/yolov10s
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="leanyolo_tpu_torch serving export")
    p.add_argument("--model", default="yolov10s")
    p.add_argument("--weights", default="PRETRAINED_COCO")
    p.add_argument("--out", default=None, help="output path (default runs/export/<model>)")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--sizes", default=None,
                   help="comma list of bucket sizes (e.g. 640,960,1280): one artifact per size + manifest.json")
    p.add_argument("--decode", choices=["topk", "nms"], default="topk")
    p.add_argument("--max-dets", type=int, default=300)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--pre-topk", type=int, default=1000)
    p.add_argument("--dtype", choices=["float32", "bf16"], default="float32")
    p.add_argument("--static-batch", action="store_true", help="fixed batch=1 instead of dynamic")
    p.add_argument("--no-fuse", action="store_true", help="skip BN folding / RepVGGDW fusion")
    p.add_argument("--class-names", default=None)
    p.add_argument("--validate", action="store_true")
    p.add_argument("--device", default="cuda", help="where the artifact runs: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def compare(got, ref, label: str) -> bool:
    """Print and return whether (dets, num) are equal: num equal, dets bit-equal."""
    import torch

    (gd, gn), (rd, rn) = got, ref
    shape_ok = tuple(gd.shape) == tuple(rd.shape)
    num_ok = shape_ok and bool(torch.equal(gn.cpu(), rn.cpu()))
    bits_ok = shape_ok and bool(torch.equal(gd.cpu().view(torch.int32), rd.cpu().view(torch.int32)))
    diff = float((gd.cpu() - rd.cpu()).abs().max()) if shape_ok and gd.numel() else 0.0
    print(f"validate {label}: shape={tuple(gd.shape)} num_dets equal={num_ok} dets bit-equal={bits_ok} "
          f"max|diff|={diff:.3g}")
    return num_ok and bits_ok


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)

    import torch

    from ..data.coco import coco80_class_names
    from ..export.serving import (BucketedServing, build_serving_fn, export_serving, export_serving_bucketed,
                                  load_exported)
    from ..models.registry import get_model
    from ..ops.letterbox import choose_bucket, letterbox

    class_names = args.class_names.split(",") if args.class_names else coco80_class_names()
    weights = None if args.weights in ("none", "None", "") else args.weights
    model = get_model(args.model, weights=weights, class_names=class_names)
    kw = dict(decode=args.decode, max_dets=args.max_dets, conf=args.conf, iou=args.iou, pre_topk=args.pre_topk,
              dtype=args.dtype, fuse=not args.no_fuse, device=args.device)

    if args.sizes:
        sizes = sorted({int(s) for s in args.sizes.split(",")})
        if args.imgsz not in sizes:
            print(f"note: --sizes {args.sizes} overrides --imgsz; {args.imgsz} is NOT among the exported buckets "
                  f"(add it to --sizes if you want it served)")
        out = args.out or f"runs/export/{args.model}_{args.decode}_bucketed"
        mpath = export_serving_bucketed(model, out, sizes=sizes, dynamic_batch=not args.static_batch, **kw)
        print(f"exported {len(sizes)} buckets: {mpath}")
        if args.validate:
            # Round trip: mixed-size images through the bucketed server, each
            # against the live module of its bucket on the same letterbox.
            rs = np.random.RandomState(0)
            imgs = [rs.randint(0, 256, (sizes[0] // 2, sizes[0] // 4 * 3, 3), np.uint8),
                    rs.randint(0, 256, (max(sizes) * 2, max(sizes), 3), np.uint8)]
            served = BucketedServing(mpath)
            dets = served.predict_images(imgs, apply_conf_filter=False)
            if not (len(dets) == len(imgs) and all(d is not None and d.shape[-1] == 6 for d in dets)):
                raise SystemExit("validation FAILED")
            print(f"validate: per-image dets {[d.shape for d in dets]}")
            ok = True
            for img in imgs:
                size = choose_bucket(img.shape[:2], sizes, max(sizes))
                lb, _, _ = letterbox(img, size)
                x = torch.from_numpy(np.ascontiguousarray(lb, dtype=np.float32)[None])
                fn, _ = build_serving_fn(model, imgsz=size, **kw)
                dev = next(fn.parameters()).device
                with torch.no_grad():
                    ok &= compare(served._fn(size)(x.to(dev)), fn(x.to(dev)), f"bucket {size}")
            if not ok:
                raise SystemExit("validation FAILED")
            print("validation PASSED")
        return

    out = args.out or f"runs/export/{args.model}_{args.decode}_{args.imgsz}"
    path = export_serving(model, out, imgsz=args.imgsz, dynamic_batch=not args.static_batch, **kw)
    print(f"exported: {path} (+ {path}.json)")
    if args.validate:
        fn, _ = build_serving_fn(model, imgsz=args.imgsz, **kw)
        dev = next(fn.parameters()).device
        x = torch.from_numpy(np.random.RandomState(0).uniform(0, 255, (1, args.imgsz, args.imgsz, 3))
                             .astype(np.float32)).to(dev)
        with torch.no_grad():
            ok = compare(load_exported(path)(x), fn(x), "artifact")
        if not ok:
            raise SystemExit("validation FAILED")
        print("validation PASSED")


if __name__ == "__main__":
    main()
