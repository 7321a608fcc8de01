"""Times the training step's own kernels on the card: the training BN's
batch moments (K8, `bn_moments`) at each BN shape of a yolov10s 640
batch-32 step, and the task-aligned assignment's candidates kernel
(`tal_candidates`) on a training step's own inputs, for three batches: the
draw of chip_smoke.py's training phase (bench_train.py's: 24 GT slots an
image, 40% valid, boxes 8-60 px, cut to the bucket of 16), the same draw at
1536 px and batch 8 (A = 48,384: the candidates kernel in two passes) and
the draw of `profile_step --mode train` (32 slots an image, all valid,
every box [4, 4, 320, 320]).

    python -m leanyolo_tpu_torch.tools.time_train_kernels [--json out.json]

Each time: CUDA events (median of 20 runs, each the mean of 10 back-to-back
launches) and the profiler's device time (K8: each shape's mean kernel
record over profiles of the step's 99 launches in order, `bn_step_device_ms`;
the assignment: the mean kernel record of 20 launches), beside the bound
(kernels/bounds.py). K8's step total counts each shape as often as the step
has it. chip_smoke.py takes its K8 and assignment records from
`time_bn(full=True)` and `time_tal_calls(full=True)`, which add K8's
backward and the targets kernel, the plain versions and the library's one
call for the same function (K8: torch.batch_norm_stats and torch.addcmul;
none computes the assignment). The card's name and power limit head the
output. Run it in two checkouts in turns (parent, change, change, parent)
to compare them on one card.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import Counter
from typing import Callable, Optional, Sequence

from ..utils.profiling import _family, card_line, events_ms

SEED = 0
INNER = 10  # back-to-back launches a timed run
PROFILE_PAD_S = 0.05  # idle seconds on each side of a profiled window, doubled at each retry


def kernel_ms(fn: Callable, kernel: str, calls: int = 20) -> float:
    """Mean device ms of `kernel`'s records over `calls` calls of fn (each
    launching it once), under torch.profiler; profiled again, four times
    at most, while it keeps no record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        pad = PROFILE_PAD_S * 2 ** attempt
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


def bn_step_device_ms(kernel: str, launches: list, calls: int = 2) -> tuple:
    """(device ms of the step's launches, "K of M kernel records kept",
    {shape: mean device ms of its kept records}):
    `launches` is [(shape, fn)], each fn launching `kernel` once, run in
    order `calls` times a profile.

    A profile can lose kernel records, and one kernel of 14 shapes whose
    launches differ 7x in time gives no mean that stands for the step. Each
    kept kernel record is matched to its launch by the correlation id it
    shares with the launch's runtime record, so its shape is known, and the
    step's time is each shape's mean kept record times the step's count of
    the shape: a lost record moves no weight between shapes. A profile is
    taken again, four times at most, until every shape has a record; a
    profile whose runtime records are not one a launch is not used."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _, fn in launches:
        fn()
    torch.cuda.synchronize()
    counts = Counter(shape for shape, _ in launches)
    kept, us = Counter(), Counter()
    taken = 0
    for attempt in range(4):
        pad = PROFILE_PAD_S * 2 ** attempt
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                for _, fn in launches:
                    fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.events()
        runtime = sorted((e for e in events if e.device_type.name == "CPU" and "LaunchKernel" in e.name),
                         key=lambda e: e.time_range.start)
        records = {e.id: e.time_range.elapsed_us() for e in events
                   if e.device_type.name == "CUDA" and _family(e.name) == kernel + "_kernel"}
        if len(runtime) != calls * len(launches):
            print(f"{kernel} step profile {attempt + 1}: {len(runtime)} launch records of "
                  f"{calls * len(launches)}; profiling again", flush=True)
            continue
        taken += calls * len(launches)
        for (shape, _), e in zip(launches * calls, runtime):
            if e.id in records:
                kept[shape] += 1
                us[shape] += records[e.id]
        if all(kept[shape] for shape in counts):
            break
    if not all(kept[shape] for shape in counts):
        raise RuntimeError(f"{kernel} step profile: shapes with no kernel record in {attempt + 1} profiles: "
                           f"{[list(s) for s in counts if not kept[s]]}")
    by_shape = {shape: us[shape] / kept[shape] / 1e3 for shape in counts}
    ms = sum(by_shape[shape] * n for shape, n in counts.items())
    kept_line = f"{sum(kept.values())} of {taken} kernel records kept"
    print(f"{kernel} step profile: {kept_line}", flush=True)
    return ms, kept_line, by_shape


def _bound(nbytes: float, nops: float) -> dict:
    from ..kernels import bounds

    ms, by = bounds.bound(nbytes, nops, bounds.FP32_OPS_PER_S)
    return {"bound_ms": ms, "bound_by": by}


def time_bn(seed: int = SEED, full: bool = False) -> dict:
    """K8 over the 99 BN inputs of a batch-32 yolov10s 640 bf16 training
    forward: each of the 14 shapes timed once and counted as often as the
    step has it. -> {"bn_moments": {ms, device_ms, device_records,
    bound_ms, bound_by[, plain_ms, library_ms]}, "shapes": [...]}, with
    full=True also "bn_moments_bwd" and the plain versions and the library
    calls (torch.batch_norm_stats(y, 1e-3) for the forward,
    torch.addcmul(g_s1, y, g_s2, value=2, out=dy) for the backward; timed
    only)."""
    import torch

    from ..kernels import bnstats, bounds

    g = torch.Generator(device="cuda").manual_seed(seed + 19)
    step_shapes = [tuple(s) for s in bounds.train_bn_shapes("yolov10s", 640, 32)]
    counts = Counter(step_shapes)
    parts = ("bn_moments", "bn_moments_bwd") if full else ("bn_moments",)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") if full else ("ms", "bound_ms")
    out = {part: dict.fromkeys(keys, 0.0) for part in parts}
    ins, rows = {}, []
    print(f"bn_moments per shape (bf16 channels_last, BNs of the step): {', '.join(keys)}"
          + (f" | backward: {', '.join(keys)}" if full else ""), flush=True)
    for shape, k in sorted(counts.items(), key=lambda kv: -kv[0][1] * kv[0][2] * kv[0][3]):
        y = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        g1, g2 = torch.randn(shape[1], generator=g, device="cuda"), torch.randn(shape[1], generator=g, device="cuda")
        ins[shape] = (y, g1, g2)
        n = shape[0] * shape[2] * shape[3]
        row = {"bn_moments": {"ms": events_ms(lambda: bnstats.bn_moments(y), inner=INNER),
                              "bound_ms": bounds.bound(*bounds.bn_moments_work(n, shape[1]),
                                                       bounds.FP32_OPS_PER_S)[0]}}
        if full:
            dy = torch.empty_like(y)
            row["bn_moments"].update(
                plain_ms=events_ms(lambda: bnstats.bn_moments_plain(y), warmup=1, runs=5, inner=2),
                library_ms=events_ms(lambda: torch.batch_norm_stats(y, 1e-3), inner=INNER))
            row["bn_moments_bwd"] = {
                "ms": events_ms(lambda: bnstats.bn_moments_bwd(y, g1, g2), inner=INNER),
                "plain_ms": events_ms(lambda: bnstats.bn_moments_bwd_plain(y, g1, g2), warmup=1, runs=5, inner=2),
                "library_ms": events_ms(lambda: torch.addcmul(g1.view(1, -1, 1, 1), y, g2.view(1, -1, 1, 1),
                                                              value=2.0, out=dy), inner=INNER),
                "bound_ms": bounds.bound(*bounds.bn_moments_bwd_work(n, shape[1]), bounds.FP32_OPS_PER_S)[0]}
        for part in parts:
            for key in keys:
                out[part][key] += k * row[part][key]
        rows.append({"shape": list(shape), "count": k, **row})
        print(f"  {list(shape)} x{k} G {bnstats.slots(n, shape[1])} steps {bnstats.rows_per_lane(n, shape[1])}: "
              + " | ".join(" ".join(f"{row[part][key]:.5f}" for key in keys) for part in parts), flush=True)
    fns = {"bn_moments": lambda y, g1, g2: bnstats.bn_moments(y), "bn_moments_bwd": bnstats.bn_moments_bwd}
    for part in parts:
        step = [(shape, lambda a=ins[shape], f=fns[part]: f(*a)) for shape in step_shapes]
        out[part]["device_ms"], out[part]["device_records"], by_shape = bn_step_device_ms(part, step)
        out[part]["bound_by"] = "bytes"
        for row in rows:
            row[part]["device_ms"] = by_shape[tuple(row["shape"])]
        print(f"{part} device ms a launch by shape (the step's launches in a row): "
              + ", ".join(f"{list(sh)} x{counts[sh]} {ms:.5f}" for sh, ms in by_shape.items()), flush=True)
    for part in parts:
        r = out[part]
        lib = {"bn_moments": "torch.batch_norm_stats", "bn_moments_bwd": "torch.addcmul"}[part]
        print(f"{part} over the step's {len(step_shapes)} launches (a batch-32 yolov10s 640 bf16 training step): "
              f"events {r['ms']:.4f} ms, device {r['device_ms']:.4f} ({r['device_records']}), bound "
              f"{r['bound_ms']:.4f} (bytes)" + (f", plain {r['plain_ms']:.4f}, {lib} {r['library_ms']:.4f}"
                                                if full else ""), flush=True)
    return {**out, "shapes": rows}


def train_batches():
    """{name: Batch}: chip_smoke.py's draw (bench_train.py's; also at 1536
    px, batch 8) and profile_step's."""
    import numpy as np

    from ..data.dataset import Batch
    from .bench_train import synthetic_batch

    b, size = 32, 640
    smoke = Batch(*synthetic_batch(b, size, 24, SEED), [None] * b)  # chip_smoke.py::train_batch's first draw
    wide = Batch(*synthetic_batch(8, 1536, 24, SEED), [None] * 8)
    rng = np.random.RandomState(0)  # profile_step.py::build_step
    prof = Batch(rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8),
                 rng.randint(0, 80, (b, 32)).astype(np.int32),
                 np.tile(np.asarray([4.0, 4.0, size / 2, size / 2], np.float32), (b, 32, 1)),
                 np.ones((b, 32), bool), [None] * b)
    return {"chip_smoke_step": smoke, "chip_smoke_step_1536": wide, "profile_step": prof}


def capture_tal_calls(tr, batch, gen) -> list:
    """[(args, kwargs)] of the assignment's calls in one training step of
    `tr` (one2many at k = 10, one2one at k = 1), each input copied with its
    strides."""
    import torch

    from ..kernels import tal

    calls, assign = [], tal.assign

    def spy(*a, **kw):
        calls.append(([torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t) for t in a],
                      dict(kw)))
        return assign(*a, **kw)

    tal.assign = spy
    try:
        tr.train_step(batch, gen)
    finally:
        tal.assign = assign
    return calls


def time_tal_calls(calls: list, full: bool = False) -> dict:
    """The candidates kernel (with full=True also the targets kernel and
    each pass's plain version: candidates_plain, targets_plain) on the
    assignment's `calls`, each kernel alone, summed over them: {"calls":
    rows, "tal_candidates": {ms, device_ms, bound_ms, bound_by[,
    plain_ms]}[, "tal_targets": ...]}. The bound (bounds.tal_work) counts
    the valid slots, the images that hold one and the (slot, anchor) pairs
    inside a box of these inputs. No single PyTorch call computes the
    assignment: library none."""
    import torch

    from ..kernels import bounds, tal

    parts = ("candidates", "targets") if full else ("candidates",)
    keys = ("ms", "device_ms", "plain_ms") if full else ("ms", "device_ms")
    work = {part: [0, 0] for part in parts}
    out = {f"tal_{part}": dict.fromkeys(keys, 0.0) for part in parts}
    rows = []
    for args, kw in calls:
        scores, pd, anc, labels, gt, mask = args
        topk, nc = kw["topk"], kw["num_classes"]
        b, a, c = scores.shape
        inputs = tal._inputs(*args, topk)
        w, h = tal.candidates(scores, inputs)[:2]
        k = min(topk, a)
        winners, has_any, mask_in, overlaps, _ = tal.candidates_plain(*args, k)
        fns = {"candidates": (lambda: tal.candidates(scores, inputs), lambda: tal.candidates_plain(*args, k)),
               "targets": (lambda: tal.targets(inputs, w, h, nc),
                           lambda: tal.targets_plain(winners, has_any, mask_in, overlaps, labels, gt, nc,
                                                     scores.dtype))}
        valid, images, inside = int(mask.sum()), int(mask.any(1).sum()), int(mask_in.sum())
        row = {"topk": topk, "shape": [b, labels.shape[1], a], "classes": c, "valid": valid, "images": images,
               "inside": inside}
        for part in parts:
            kernel, plain = fns[part]
            t = {"ms": events_ms(kernel, inner=INNER), "device_ms": kernel_ms(kernel, f"tal_{part}_kernel")}
            if full:
                t["plain_ms"] = events_ms(plain, warmup=1, runs=5, inner=2)
            wk = bounds.tal_work(b, labels.shape[1], a, c, topk, valid=valid, images=images, inside=inside, part=part)
            t.update(_bound(*wk))
            work[part] = [work[part][0] + wk[0], work[part][1] + wk[1]]
            for key in keys:
                out[f"tal_{part}"][key] += t[key]
            row[part] = t
        rows.append(row)
        print(f"tal k = {topk}, {row['shape']} {c} classes, {valid} valid slots in {images} images, {inside} "
              f"(slot, anchor) pairs inside: " + "; ".join(
                  f"{part} events {row[part]['ms']:.5f} ms, device {row[part]['device_ms']:.5f}"
                  + (f", plain {row[part]['plain_ms']:.5f}" if full else "")
                  + f", bound {row[part]['bound_ms']:.6f} ({row[part]['bound_by']})" for part in parts), flush=True)
        torch.cuda.empty_cache()
    for part in parts:
        out[f"tal_{part}"].update(_bound(*work[part]))
    return {"calls": rows, **out}


def time_tal() -> dict:
    """`time_tal_calls` on each draw of `train_batches`, the calls of one
    yolov10s training step (bf16, augmented) on it."""
    import torch

    from ..engine.trainer import TrainConfig, Trainer
    from ..models.registry import get_model

    out = {}
    for name, batch in train_batches().items():
        model = get_model("yolov10s", weights=None, class_names=[f"c{i}" for i in range(80)])
        tr = Trainer(model, TrainConfig(bf16=True, augment=True, grad_clip=1.0, steps_per_epoch=1000), device="cuda")
        calls = capture_tal_calls(tr, batch, torch.Generator(device="cuda").manual_seed(SEED))
        del tr, model
        torch.cuda.empty_cache()
        out[name] = time_tal_calls(calls)
        c = out[name]["tal_candidates"]
        print(f"tal_candidates {name}, the step's {len(calls)} calls: events {c['ms']:.5f} ms, device "
              f"{c['device_ms']:.5f}, bound {c['bound_ms']:.6f} ({c['bound_by']})", flush=True)
        del calls
        torch.cuda.empty_cache()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="write the times here too")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_train_kernels: no CUDA device")
    res = {"card": card_line(), "device": torch.cuda.get_device_name(0)}
    print(res["card"], flush=True)
    res["bn_moments"] = time_bn()
    res["tal"] = time_tal()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
