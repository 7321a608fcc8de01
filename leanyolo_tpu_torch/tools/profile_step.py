"""Profile one inference or training step and print the device-time table.

Captures a `torch.profiler` trace of N steps of the hot path (after one
warm-up step outside the trace, which also builds the kernels) and sums
the device's kernel time per family (utils/profiling.py): each of the port's
hand-written kernels is a family of its own. Beside the table it prints the
median wall ms of the profiled steps (host clock, each step ending in a
synchronize; under the profiler), on the card the median of as many
unprofiled steps by CUDA events (each from an idle card, its synchronize
inside the span) and the peak GiB allocated over the profiled ones.
Counterpart of the JAX package's `tools/profile_step.py`, with the same
flags and JSON, plus --device, `--mode decode` (the inference step's decode
alone, on the head maps of one forward made before the trace) and `--mode
export` (a request of the serving export's `.pt2` artifact, export/serving.py:
exported with --decode and --dtype, always folded, saved and loaded again,
on random float32 pixels); runs on the card unless --device names another
(on the CPU the table holds the CPU operators' self time).

Examples:
    python -m leanyolo_tpu_torch.tools.profile_step --mode infer --model yolov10s \\
        --imgsz 640 --batch-size 32 --dtype bf16 --fuse --steps 5
    python -m leanyolo_tpu_torch.tools.profile_step --mode train --model yolov10s \\
        --imgsz 640 --batch-size 32 --out-dir runs/prof --json prof.json
    python -m leanyolo_tpu_torch.tools.profile_step --mode decode --decode nms --fuse \\
        --batch-size 1 --top 40
    python -m leanyolo_tpu_torch.tools.profile_step --mode export --decode topk \\
        --batch-size 32 --steps 20 --json export.json
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Optional, Sequence

# Captures taken before giving up on a trace with no kernel records, the pad
# doubling at each (utils/profiling.py: PAD_S).
CAPTURE_TRIES = 4


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="yolov10s")
    p.add_argument("--weights", default="none", help="'none' (random), 'PRETRAINED_COCO', or a checkpoint path")
    p.add_argument("--mode", choices=["infer", "train", "decode", "export"], default="infer",
                   help="decode: the infer step's decode alone, on the head maps of one forward; export: a "
                        "request of the serving export's artifact")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--dtype", choices=["float32", "bf16"], default="bf16")
    p.add_argument("--decode", choices=["topk", "nms"], default="topk")
    p.add_argument("--fuse", action="store_true", help="fold BN/norm into conv weights (serving path)")
    p.add_argument("--steps", type=int, default=3, help="profiled steps (after one warmup)")
    p.add_argument("--max-boxes", type=int, default=32, help="train mode: GT pad per image")
    p.add_argument("--out-dir", default="runs/profile")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--json", default=None, help="also dump the family table as JSON here")
    p.add_argument("--device", default="cuda", help="where the step runs: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_step(args: argparse.Namespace):
    """The step to profile: a callable that runs one step and waits for it."""
    import numpy as np
    import torch

    from ..models.registry import get_model

    weights = None if args.weights in ("none", "None", "") else args.weights
    model = get_model(args.model, weights=weights, class_names=[f"c{i}" for i in range(80)])
    device = torch.device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    rng = np.random.RandomState(0)
    if args.mode == "export":
        from ..export.serving import export_serving, load_exported

        with tempfile.TemporaryDirectory() as tmp:  # the artifact is held in memory once loaded
            art = load_exported(export_serving(model, os.path.join(tmp, "serving"), imgsz=args.imgsz,
                                               decode=args.decode, dtype=args.dtype, device=device))
        x = torch.from_numpy(rng.rand(args.batch_size, args.imgsz, args.imgsz, 3).astype(np.float32) * 255)
        x = x.to(device)

        def step():
            with torch.no_grad():
                art(x)
            sync()

        return step

    if args.mode in ("infer", "decode"):
        from ..engine.predictor import Predictor

        pred = Predictor(model, imgsz=args.imgsz, decode=args.decode, dtype=args.dtype, fuse=args.fuse,
                         device=device)
        x = torch.from_numpy(rng.randint(0, 256, (args.batch_size, args.imgsz, args.imgsz, 3)).astype(np.uint8))
        x = x.to(device)
        if args.mode == "decode":
            raw = pred.raw(x)

            def step():
                pred.decode_raw(raw)
                sync()

            return step

        def step():
            pred.run_batch(x)
            sync()

        return step

    from ..data.dataset import Batch
    from ..engine.trainer import TrainConfig, Trainer

    cfg = TrainConfig(epochs=1, steps_per_epoch=1, augment=True, grad_clip=1.0,
                      bf16=args.dtype in ("bf16", "bfloat16"))
    trainer = Trainer(model, cfg, device=device)
    b, n = args.batch_size, args.max_boxes
    batch = Batch(
        rng.randint(0, 256, (b, args.imgsz, args.imgsz, 3)).astype(np.uint8),
        rng.randint(0, 80, (b, n)).astype(np.int32),
        np.tile(np.asarray([4.0, 4.0, float(args.imgsz) / 2, float(args.imgsz) / 2], np.float32), (b, n, 1)),
        np.ones((b, n), bool),
        [None] * b,
    )

    def step():
        # The same augmentation draws each step, as JAX's one key gives.
        trainer.train_step(batch, torch.Generator(device=device).manual_seed(0))
        sync()

    return step


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    import torch

    from ..utils.profiling import PAD_S, capture_trace, format_table, summarize_trace

    cuda = torch.device(args.device).type == "cuda"
    step = build_step(args)
    step()  # warm-up (and the kernels' build) outside the trace
    event_ms = None
    if cuda:
        events = []
        for _ in range(args.steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
            events.append(start.elapsed_time(end))
        event_ms = statistics.median(events)
    for attempt in range(CAPTURE_TRIES):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        walls = []
        with capture_trace(args.out_dir, pad_s=PAD_S * 2**attempt):
            for _ in range(args.steps):
                t0 = time.perf_counter()
                step()
                walls.append((time.perf_counter() - t0) * 1e3)
        try:
            summary = summarize_trace(args.out_dir, steps=args.steps)
            break
        except RuntimeError as e:  # no kernel records: capture again with a longer pad
            if attempt == CAPTURE_TRIES - 1:
                raise
            print(f"capture {attempt + 1}: {e}; capturing again", flush=True)
    wall_ms = statistics.median(walls)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    print(format_table(summary, top=args.top))
    print(f"wall {wall_ms:.3f} ms/step (host clock, median of the {args.steps} profiled steps); "
          + (f"{event_ms:.4f} ms/step by CUDA events (median of {args.steps} unprofiled steps); peak "
             f"{peak_gib:.3f} GiB allocated" if cuda else "CUDA events and peak not measured (CPU)"))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(
                {
                    "plane": summary.plane,
                    "total_ms_per_step": summary.total_ms,
                    "steps": summary.steps,
                    "wall_ms_median": wall_ms,
                    "event_ms_median": event_ms,
                    "peak_gib": peak_gib,
                    "families": [
                        {"name": fa.name, "ms_per_step": fa.total_ms, "count": fa.count, "example": fa.example}
                        for fa in summary.families
                    ],
                },
                f,
                indent=2,
            )
        print(f"json: {args.json}")


if __name__ == "__main__":
    main()
