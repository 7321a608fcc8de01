"""Times two kernels of the training step on the card: the training BN's
batch-moments forward (K8, `bn_moments`) at each BN shape of a yolov10s
640 batch-32 step, and the task-aligned assignment's candidates kernel
(`tal_candidates`) on a training step's own inputs, for two batches: the
draw of chip_smoke.py's training phase (bench_train.py's: 24 GT slots an
image, 40% valid, boxes 8-60 px, cut to the bucket of 16) and the draw of
`profile_step --mode train` (32 slots an image, all valid, every box
[4, 4, 320, 320]).

    python -m leanyolo_tpu_torch.tools.time_train_kernels --json out.json

Each time: CUDA events (median of 20 runs, each the mean of 10 back-to-back
launches) and the profiler's device time (the mean kernel record of 20
launches). K8's step total counts each shape as often as the step has it.
The card's name and power limit head the output. Run it in two checkouts
in turns (parent, change, change, parent) to compare them on one card; it
uses only wrappers both sides have.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import Counter
from typing import Callable, Optional, Sequence

SEED = 0
RUNS, INNER = 20, 10


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def events_ms(fn: Callable) -> float:
    """Median ms of fn() over RUNS runs, each the mean of INNER calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def kernel_ms(fn: Callable, kernel: str, calls: int = 20) -> float:
    """Mean device ms of `kernel`'s records over `calls` calls of fn (each
    launching it once), under torch.profiler; profiled again, four times
    at most, while it keeps no record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..utils.profiling import _family

    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        pad = 0.05 * 2 ** attempt
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type.name == "CUDA" and _family(e.name) == kernel]
        if us:
            return sum(us) / len(us) / 1e3
    raise RuntimeError(f"no {kernel} record in four profiles")


def time_bn() -> dict:
    import torch

    from ..kernels import bnstats, bounds

    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    counts = Counter(bounds.train_bn_shapes("yolov10s", 640, 32))
    rows, total = [], {"events_ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0}
    for shape, k in sorted(counts.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3]):
        y = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        rows_, c = shape[0] * shape[2] * shape[3], shape[1]
        row = {"shape": list(shape), "count": k, "events_ms": events_ms(lambda: bnstats.bn_moments(y)),
               "device_ms": kernel_ms(lambda: bnstats.bn_moments(y), "bn_moments_kernel"),
               "bound_ms": bounds.bound(*bounds.bn_moments_work(rows_, c), bounds.FP32_OPS_PER_S)[0]}
        for key in total:
            total[key] += k * row[key]
        rows.append(row)
        print(f"bn_moments {shape} x{k}: events {row['events_ms']:.5f} ms, device {row['device_ms']:.5f}, "
              f"bound {row['bound_ms']:.5f}", flush=True)
    print(f"bn_moments over the step's {sum(counts.values())} launches: events {total['events_ms']:.4f} ms, "
          f"device {total['device_ms']:.4f}, bound {total['bound_ms']:.4f}", flush=True)
    return {"shapes": rows, **total}


def train_batches():
    """{name: Batch}: chip_smoke.py's draw and profile_step's."""
    import numpy as np

    from ..data.dataset import Batch

    b, size = 32, 640
    rng = np.random.RandomState(SEED)  # chip_smoke.py::train_batch, in its order of draws
    x1, y1 = rng.uniform(0, size - 60, (2, b, 24)).astype(np.float32)
    wh = rng.uniform(8, 60, (2, b, 24)).astype(np.float32)
    images = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    labels = rng.randint(0, 80, (b, 24)).astype(np.int32)
    boxes = np.stack([x1, y1, x1 + wh[0], y1 + wh[1]], axis=-1)
    mask = rng.uniform(size=(b, 24)) < 0.4
    smoke = Batch(images, labels, boxes, mask, [None] * b)
    rng = np.random.RandomState(0)  # profile_step.py::build_step
    prof = Batch(rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8),
                 rng.randint(0, 80, (b, 32)).astype(np.int32),
                 np.tile(np.asarray([4.0, 4.0, size / 2, size / 2], np.float32), (b, 32, 1)),
                 np.ones((b, 32), bool), [None] * b)
    return {"chip_smoke_step": smoke, "profile_step": prof}


def time_tal() -> dict:
    import torch

    from ..engine.trainer import TrainConfig, Trainer
    from ..kernels import tal
    from ..models.registry import get_model

    out = {}
    for name, batch in train_batches().items():
        model = get_model("yolov10s", weights=None, class_names=[f"c{i}" for i in range(80)])
        tr = Trainer(model, TrainConfig(bf16=True, augment=True, grad_clip=1.0, steps_per_epoch=1000), device="cuda")
        calls, assign = [], tal.assign

        def spy(*a, **kw):  # copies that keep each input's strides
            calls.append(([torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)
                           for t in a], dict(kw)))
            return assign(*a, **kw)

        tal.assign = spy
        try:
            tr.train_step(batch, torch.Generator(device="cuda").manual_seed(SEED))
        finally:
            tal.assign = assign
        torch.cuda.synchronize()
        rows = []
        for args, kw in calls:
            inputs = tal._inputs(*args, kw["topk"])
            fn = lambda: tal.candidates(args[0], inputs)  # noqa: E731
            rows.append({"topk": kw["topk"], "shape": [*args[0].shape, args[3].shape[1]],
                         "valid": int(args[5].sum()), "events_ms": events_ms(fn),
                         "device_ms": kernel_ms(fn, "tal_candidates_kernel")})
            print(f"tal_candidates {name} k = {kw['topk']} {rows[-1]['shape']} ({rows[-1]['valid']} valid): "
                  f"events {rows[-1]['events_ms']:.5f} ms, device {rows[-1]['device_ms']:.5f}", flush=True)
        out[name] = {"calls": rows, "events_ms": sum(r["events_ms"] for r in rows),
                     "device_ms": sum(r["device_ms"] for r in rows)}
        print(f"tal_candidates {name}, the step's {len(rows)} calls: events {out[name]['events_ms']:.5f} ms, "
              f"device {out[name]['device_ms']:.5f}", flush=True)
        del tr, model, calls
        torch.cuda.empty_cache()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the times here too")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_train_kernels: no CUDA device")
    res = {"card": card(), "device": torch.cuda.get_device_name(0)}
    print(res["card"], flush=True)
    res["bn_moments"] = time_bn()
    res["tal_candidates"] = time_tal()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
