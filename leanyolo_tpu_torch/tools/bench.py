"""Inference benchmark: a YOLOv10 variant's end-to-end serving throughput
on one card, or its batch-1 latency.

    python -m leanyolo_tpu_torch.tools.bench [--variant yolov10s] [--imgsz 640]
        [--batch-sizes 32,128] [--decode topk|nms] [--latency] [--device cuda|cpu]

Counterpart of the JAX package's `bench.py`, with its flags, its JSON line
and its metric names (`{variant}_{imgsz}_bf16[_nms]_images_per_sec_per_chip`,
`..._bs1_latency_ms`). What is timed is the port's main serving path: a
model from the registry (80 classes, random weights from a seed) served by
`Predictor(model, imgsz, decode=..., dtype="bfloat16", fuse=True)`, whose
`run_batch` takes a uint8 [bs, S, S, 3] batch already on the device
(`serving_predictor`). With `--decode nms` the decode is the JAX bench's:
conf 0.25, IoU 0.45, class-wise, max_det 300, the predictor's pre_topk of
1000.

Throughput is chain x bs / wall, where wall runs from the first of `chain`
back-to-back `run_batch` calls to the synchronize after the last, after one
warm-up chain at the same shapes (batch drawn from RandomState(0)); the
timed chain runs on a fresh batch (RandomState(1)): one readback a chain, as
in the JAX bench. `bench_latency` fits wall(n) = overhead + n x step over
chains of n batch-1 calls. The JAX bench also made each iteration depend on
the last and ran the chain in one `fori_loop` program: a remote TPU cached
repeated executions and returned before it finished. Eager PyTorch runs
every call and `torch.cuda.synchronize` waits for the last, so neither is
ported. Nor is `--approx` (`lax.approx_max_k` is a TPU approximation) or
the wait for a TPU backend: the default `--device cuda` fails at once with
no card, and `--device cpu` is the explicit way to run on the CPU.

A batch size that does not fit (`torch.OutOfMemoryError`) ends the sweep and
keeps the sizes before it; any other error propagates. With
`--data-parallel N` (or `--spatial-parallel N`) the job is N processes, one
card each (`torchrun --nproc-per-node=N`, or `--distributed` with its
coordinator flags), on the port's mesh (`parallel/mesh.py`), every process
feeding the global batch; the value is then the mesh's aggregate
throughput, printed by process 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.profiling import card_line, chain_s

NC = 80
# The JAX bench's NMS decode (bench.py:68-71): BASELINE config 3.
NMS = dict(conf_thresh=0.25, iou_thresh=0.45, max_det=300, class_wise_nms=True)


def build_model(variant: str, seed: int = 0):
    """The variant with 80 classes and random weights from `seed`, on the CPU."""
    from ..models.registry import get_model

    return get_model(variant, weights=None, class_names=[f"c{i}" for i in range(NC)], seed=seed)


def serving_predictor(model, imgsz: int, decode: str = "topk", device="cuda", mesh=None):
    """The timed serving path: the model folded to bf16, either decode."""
    from ..engine.predictor import Predictor

    kw = NMS if decode == "nms" else dict(max_det=NMS["max_det"])
    return Predictor(model, imgsz=imgsz, decode=decode, dtype="bfloat16", fuse=True, device=device, mesh=mesh,
                     **kw)


def make_batch(bs: int, imgsz: int, seed: int, device) -> torch.Tensor:
    """uint8 [bs, imgsz, imgsz, 3] pixels from RandomState(seed), on `device`."""
    x = np.random.RandomState(seed).randint(0, 256, (bs, imgsz, imgsz, 3), np.uint8)
    return torch.from_numpy(x).to(device)


def free_device(what: str = "", bs: int = 0) -> None:
    """Return the device's cached blocks; with `what`, after batch `bs` of it
    did not fit, and say so."""
    if what:
        print(f"{what}: batch {bs} does not fit in the device's memory; the sweep ends", file=sys.stderr, flush=True)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card (pass --device cpu to run on the CPU)")


def device_detail(device: str) -> dict:
    """What ran the benchmark: the card's name and power limit, or the CPU."""
    if torch.device(device).type == "cuda":
        return {"device": torch.cuda.get_device_name(0), "card": card_line()}
    return {"device": "cpu", "card": None}


def _mesh(dp: int, sp: int, device: str):
    if dp <= 1 and sp <= 1:
        return None
    from ..parallel import mesh as pmesh

    return pmesh.make_sp_mesh(1, sp, device=device) if sp > 1 else pmesh.make_mesh(dp, device=device)


def bench_variant(variant: str = "yolov10s", imgsz: int = 640, batch_sizes=(32, 128), chain: int = 16,
                  dp: int = 0, sp: int = 0, decode: str = "topk", device: str = "cuda") -> dict:
    """{"best_ips", "best_bs", "per_bs": {bs: images/s}} over `batch_sizes`
    in order, up to the first that does not fit."""
    check_device(device)
    pred = serving_predictor(build_model(variant), imgsz, decode, device, _mesh(dp, sp, device))
    results = {}
    best_ips, best_bs = 0.0, 0
    last = {}

    def request(x):
        last["dets"] = pred.run_batch(x)[0]

    for bs in batch_sizes:
        try:
            x0, x1 = make_batch(bs, imgsz, 0, device), make_batch(bs, imgsz, 1, device)
            chain_s(lambda: request(x0), chain, device)  # warm at the same shapes
            dt = chain_s(lambda: request(x1), chain, device)  # a fresh batch
            fits = True
        except torch.OutOfMemoryError:
            fits = False
        if not fits:  # outside the handler, whose traceback holds the failed call's tensors
            x0 = x1 = None
            last.clear()
            free_device(f"{variant} {decode}", bs)
            break
        assert bool(torch.isfinite(last["dets"]).all())
        ips = chain * bs / dt
        results[bs] = ips
        if ips > best_ips:
            best_ips, best_bs = ips, bs
    return {"best_ips": best_ips, "best_bs": best_bs, "per_bs": results}


def latency_fit(walls: dict) -> dict:
    """wall(n) = overhead + n x step through the shortest and the longest
    chain: walls {n: seconds for n calls} -> step_ms, per_call_overhead_ms
    and each chain's wall a call (the JAX bench's bench.py:172-175)."""
    n1, n2 = min(walls), max(walls)
    step_ms = (walls[n2] - walls[n1]) / (n2 - n1) * 1e3
    return {"step_ms": step_ms, "per_call_overhead_ms": walls[n1] * 1e3 - n1 * step_ms,
            "wall_ms_per_step": {str(n): walls[n] / n * 1e3 for n in walls}}


def bench_latency(variant: str = "yolov10s", imgsz: int = 640, chains=(64, 256), decode: str = "topk",
                  device: str = "cuda") -> dict:
    """Batch-1 serving latency from a sweep of chain lengths (`latency_fit`):
    a single chain's wall a call mixes the fixed cost of a chain (its
    synchronize and the card's ramp) with the time a request."""
    check_device(device)
    pred = serving_predictor(build_model(variant), imgsz, decode, device)
    x0, x1 = make_batch(1, imgsz, 0, device), make_batch(1, imgsz, 1, device)
    walls = {}
    for n in chains:
        chain_s(lambda: pred.run_batch(x0), n, device)  # warm at the same chain
        walls[n] = chain_s(lambda: pred.run_batch(x1), n, device)
    return latency_fit(walls)


def decode_tag(decode: str) -> str:
    return "" if decode == "topk" else f"_{decode}"


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from ..parallel.distributed import add_distributed_args

    p = argparse.ArgumentParser(description="leanyolo_tpu_torch inference benchmark")
    p.add_argument("--variant", default="yolov10s")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch-sizes", default="32,128")
    p.add_argument("--decode", default="topk", choices=("topk", "nms"),
                   help="decode path: topk (NMS-free headline) or nms (class-wise greedy NMS, BASELINE config 3)")
    p.add_argument("--chain", type=int, default=16, help="back-to-back calls a timed chain")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="split the batch over N processes, one card each (torchrun --nproc-per-node=N)")
    p.add_argument("--spatial-parallel", type=int, default=0, metavar="N",
                   help="split image height over N processes, one card each (bs1-latency axis)")
    p.add_argument("--latency", action="store_true",
                   help="bs1 serving latency via chain-length sweep (fits out the per-chain overhead)")
    p.add_argument("--chains", default="64,256", help="--latency: the chain lengths")
    add_distributed_args(p, batch_semantics="--batch-sizes are GLOBAL batches, split over the mesh")
    p.add_argument("--device", default="cuda", help="where the model runs: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    check_device(args.device)
    tag = decode_tag(args.decode)
    if args.latency:
        r = bench_latency(args.variant, args.imgsz, tuple(int(n) for n in args.chains.split(",")),
                          decode=args.decode, device=args.device)
        print(json.dumps({
            "metric": f"{args.variant}_{args.imgsz}_bf16{tag}_bs1_latency_ms",
            "value": round(r["step_ms"], 3),
            "unit": "ms/image",
            "vs_baseline": round(r["step_ms"], 3),
            "detail": {
                "per_call_overhead_ms": round(r["per_call_overhead_ms"], 1),
                "wall_ms_per_step_by_chain": {k: round(v, 3) for k, v in r["wall_ms_per_step"].items()},
                **device_detail(args.device),
            },
        }))
        return
    mesh = args.data_parallel > 1 or args.spatial_parallel > 1
    pid = 0
    if mesh or args.distributed:
        from ..parallel.distributed import cli_distributed_setup

        _, pid = cli_distributed_setup(args.coordinator, args.num_processes, args.process_id, device=args.device)
    r = bench_variant(args.variant, args.imgsz, tuple(int(b) for b in args.batch_sizes.split(",")), args.chain,
                      dp=args.data_parallel, sp=args.spatial_parallel, decode=args.decode, device=args.device)
    if pid:
        return
    print(json.dumps({
        "metric": f"{args.variant}_{args.imgsz}_bf16{tag}_images_per_sec_per_chip",
        "value": round(r["best_ips"], 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(r["best_ips"] / 1.0, 2),
        "detail": {
            "batch_size": r["best_bs"],
            "per_batch_size": {str(k): round(v, 2) for k, v in r["per_bs"].items()},
            # On a mesh the value is the mesh's AGGREGATE throughput, not per card.
            **({"mesh": {"dp": args.data_parallel, "sp": args.spatial_parallel}} if mesh else {}),
            **device_detail(args.device),
        },
    }))


if __name__ == "__main__":
    main()
