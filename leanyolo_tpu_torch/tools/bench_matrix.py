"""Full per-variant benchmark matrix: inference + train throughput.

Runs `bench.bench_variant` and `bench_train.bench_train` for every requested
variant at its best measured batch size and emits one JSON line per cell
plus a markdown table; `--out` writes the table as JSON, which
`bench_regression` compares against a baseline.

Counterpart of the JAX package's `tools/bench_matrix.py`: the same loop,
cells ("variant/mode", or "variant@imgsz/mode" with --imgsz-in-key), JSON
lines, table and `--out` schema, so either package's `bench_regression`
reads the file. The JSON lines and the file also name the device that ran
them (`device`; the file also the card's name and power limit, `card`).

Example:
    python -m leanyolo_tpu_torch.tools.bench_matrix --out runs/bench_matrix.json
    python -m leanyolo_tpu_torch.tools.bench_matrix --variants yolov10n,yolov10s --modes infer
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from .bench import bench_variant, check_device, device_detail
from .bench_train import bench_train

# The best batch size of each (mode, variant) at 640 px on one NVIDIA H100
# 80GB HBM3 at 700 W: the fastest of a sweep over 8, 16, 32, 64 and 128 as
# far as each fits (PERF.md section 6, PR 22). Every cell is fastest at the
# largest batch that fits: training b, l and x run out of memory at 128.
# --batch-sizes overrides it for every cell.
BEST_BS = {
    "infer": {"yolov10n": 128, "yolov10s": 128, "yolov10m": 128, "yolov10b": 128, "yolov10l": 128, "yolov10x": 128},
    "nms": {"yolov10n": 128, "yolov10s": 128, "yolov10m": 128, "yolov10b": 128, "yolov10l": 128, "yolov10x": 128},
    "train": {"yolov10n": 128, "yolov10s": 128, "yolov10m": 128, "yolov10b": 64, "yolov10l": 64, "yolov10x": 64},
}


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default="yolov10n,yolov10s,yolov10m,yolov10b,yolov10l,yolov10x")
    p.add_argument("--modes", default="infer,train", help="comma subset of infer,nms,train")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch-sizes", default=None, help="override: comma list used for every cell")
    p.add_argument("--out", default=None, help="also write the table as JSON here")
    p.add_argument("--imgsz-in-key", action="store_true",
                   help="emit cells keyed 'variant@imgsz/mode' (the multi-size baseline format)")
    p.add_argument("--chain", type=int, default=16, help="inference: back-to-back calls a timed chain")
    p.add_argument("--steps", type=int, default=16, help="training: warm-up steps, then as many timed steps")
    p.add_argument("--device", default="cuda", help="where the models run: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    check_device(args.device)

    variants = [v.strip() for v in args.variants.split(",") if v.strip()]
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    override = tuple(int(b) for b in args.batch_sizes.split(",")) if args.batch_sizes else None
    detail = device_detail(args.device)

    table: dict = {"imgsz": args.imgsz, "cells": {}}
    for variant in variants:
        for mode in modes:
            bss = override or (BEST_BS[mode].get(variant, 32),)
            if mode == "train":
                r = bench_train(variant, args.imgsz, batch_sizes=bss, steps=args.steps, device=args.device)
            else:
                r = bench_variant(variant, args.imgsz, batch_sizes=bss, chain=args.chain,
                                  decode="nms" if mode == "nms" else "topk", device=args.device)
            if not r["per_bs"]:
                # No batch size fitted: a loud error, not a 0.0 row in the regression table.
                raise RuntimeError(f"{variant}/{mode}: no batch size in {bss} produced a measurement")
            cell = {
                "images_per_sec_per_chip": round(r["best_ips"], 2),
                "batch_size": r["best_bs"],
                "per_bs": {str(k): round(v, 2) for k, v in r["per_bs"].items()},
            }
            key = f"{variant}@{args.imgsz}/{mode}" if args.imgsz_in_key else f"{variant}/{mode}"
            table["cells"][key] = cell
            print(json.dumps({
                "metric": f"{variant}_{args.imgsz}_bf16_{mode}_images_per_sec_per_chip",
                "value": cell["images_per_sec_per_chip"],
                "unit": "images/sec/chip",
                "batch_size": cell["batch_size"],
                "device": detail["device"],
            }), flush=True)

    print("\n| Variant | " + " | ".join(modes) + " |")
    print("|---" * (len(modes) + 1) + "|")
    for variant in variants:
        row = [variant]
        for mode in modes:
            c = table["cells"].get(
                f"{variant}@{args.imgsz}/{mode}" if args.imgsz_in_key else f"{variant}/{mode}")
            row.append(f"{c['images_per_sec_per_chip']} (bs{c['batch_size']})" if c else "-")
        print("| " + " | ".join(row) + " |")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({**table, **detail}, f, indent=2)
        print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
