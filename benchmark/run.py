"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, this folder and
the system (`leanyolo_tpu_torch`). One process: set-up (weights and inputs
from the seed, the system's model loaded, every shape warmed up), the
measured window, with `--trace 1` a profiled stretch after it, then the
check of what the window produced against the plain reference. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last `checks`,
each number compared beside its limit (also the last lines of standard
error).

It exits with another code than 0 and prints no result when there is no
card or fewer than the cell asks for (2), when JAX, flax or the JAX package
is loaded in this process once the window has closed (3), or when the
system cannot be imported.

`--device cpu` with `--imgsz`, `--batch`, `--pool` and `--dtype` runs the
same path at a small size on the CPU (the tests' dry run); its numbers are
not the card's and are never reported as device metrics.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

FORBIDDEN = ("jax", "jaxlib", "flax", "leanyolo_tpu", "experiments")


def process_start() -> float:
    """The process's start on the host's clock (seconds since the epoch):
    its start time since boot from /proc, else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's (whole names)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


@dataclass
class LayerReadings:
    """What a per-layer metric's reader gets: the traced stretch, the host's
    mean ms a call and the other figures of the unprofiled window, and the
    cell's sizes."""

    kind: str  # "serve" or "train"
    trace: object  # timing.Trace
    host_ms: float
    window: dict  # the unprofiled window's figures (serve: serve.end_to_end's)
    cfg: dict
    imgsz: int
    batch: int


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help="cuda (the card; default) or cpu (a small dry run)")
    p.add_argument("--imgsz", type=int, default=None, help="dry run: image size in place of the mix's")
    p.add_argument("--batch", type=int, default=None, help="dry run: batch size in place of the mix's")
    p.add_argument("--pool", type=int, default=None, help="dry run: pool of batches in place of the mix's")
    p.add_argument("--dtype", default=None, help="dry run: the system's dtype in place of the configuration's")
    return p.parse_args(argv)


def _fail(msg: str, code: int):
    print(msg, file=sys.stderr)
    sys.exit(code)


def main(argv=None, *, breaker=None) -> dict:
    """Run the cell; print and return the result. `breaker(system)`, for
    the tests, may break the timed path after set-up."""
    args = _args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # Every kernel and build cache at a fixed path inside the checkout.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(root, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(root, "build", "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    from . import spec

    cell = spec.load_cell(args.workload)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            _fail("no CUDA device: the benchmark measures the card and does not fall back to the CPU", 2)
        if torch.cuda.device_count() < cell.chips:
            _fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} present", 2)
    device = torch.device(args.device)
    mix = dict(cell.traffic)
    for key in ("imgsz", "batch", "pool"):
        if getattr(args, key) is not None:
            mix[key] = getattr(args, key)
    mix.setdefault("imgsz", cell.config["imgsz"])
    if args.dtype is not None:
        cell.config = {**cell.config, "serve": {**cell.config["serve"], "dtype": args.dtype},
                       "train": {**cell.config["train"], "dtype": args.dtype}}
    card = card_line() if device.type == "cuda" else "cpu"
    print(f"card: {card}", file=sys.stderr)
    run = _serve if mix["kind"] == "serve" else _train
    result = run(cell, mix, args, device, breaker)
    found = forbidden_modules()
    if found:
        _fail(f"modules of JAX or the JAX package are loaded in this process: {found}", 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return result


def _device(device, trace) -> dict:
    import torch

    if device.type != "cuda":
        out = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    else:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace is not None:
        out["busy_s"] = trace.busy_s()
        out["window_s"] = trace.window_s()
    return out


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _settle() -> None:
    """End of set-up: every object set-up made moves out of the collector's
    reach (`gc.freeze`), so no full collection over them stalls the host
    inside the window, as a long-running server does once it is loaded."""
    gc.collect()
    gc.freeze()


def _complete(profiled, tries: int = 3):
    """A profiled stretch whose every kernel launch has its kernel record:
    a stretch that lost records is profiled again, up to `tries` times."""
    for i in range(tries):
        trace = profiled()
        if not trace.extra["dropped"] or i == tries - 1:
            return trace
        print("trace: records were lost; profiling the stretch again", file=sys.stderr)
    return trace


def _checks(numbers: dict, limits: dict) -> dict:
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def _serve(cell, mix, args, device, breaker) -> dict:
    from . import generate as G
    from . import serve
    from .spec import read_all
    from .timing import Profile

    cfg, limits = cell.config, cell.limits
    pred, pool, state, ring = serve.setup(cfg, mix, args.seed, device)
    if breaker is not None:
        breaker(pred)
    sample = G.Reservoir(args.seed, int(mix["check_requests"]))
    _settle()
    setup_s = time.time() - T_START
    served = serve.window(pred, pool, ring, args.seconds, sample)
    e2e = serve.end_to_end(served, pool.shape[1])
    print("serving: " + " ".join(f"{k} {v!r}" for k, v in e2e.items()), file=sys.stderr)
    trace, metrics, breakdown = None, None, None
    if args.trace:
        serve.wrap_spans(pred)
        n_traced = max(1, round(float(mix["trace_seconds"]) * e2e["requests"] / served.seconds))

        def stretch_trace():
            with Profile(serve.SPANS) as prof:
                serve.window(pred, pool, ring, math.inf, None, spans=True, max_requests=n_traced)
            return prof.trace(n_traced)

        trace = _complete(stretch_trace)
        r = LayerReadings("serve", trace, e2e["host_call_ms"], e2e, cfg, pool.shape[2], pool.shape[1])
        metrics = read_all(cell.per_layer, r)
        breakdown = {"device_ops": trace.top_families(), "idle_gaps": trace.idle_gaps()}
    dev = _device(device, trace)
    print(f"memory_peak_bytes {dev['memory_peak_bytes']}", file=sys.stderr)
    del pred
    _free(device)
    t0 = time.perf_counter()
    found = serve.check(cfg, state, pool, served.kept)
    print("check, printed only: " + " ".join(f"{k} {v!r}" for k, v in found.items() if k not in serve.COMPARED),
          file=sys.stderr)
    numbers = {k: found[k] for k in serve.COMPARED}
    print(f"check took {time.perf_counter() - t0:.3f} s over {len(served.kept)} requests", file=sys.stderr)
    numbers["failed_requests"] = float(served.failed)
    if metrics is None:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"},
                   **{m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end
                      if m["name"] in e2e}}
    checks = _checks(numbers, limits)
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()), "attempted": len(served.done) + served.failed,
              "failed": served.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _train(cell, mix, args, device, breaker) -> dict:
    from . import train
    from .spec import read_all
    from .timing import Profile

    cfg, limits = cell.config, cell.limits
    tr, pool, state, got, gen = train.setup(cfg, mix, args.seed, device, breaker)
    first = int(mix["setup_steps"])
    _settle()
    setup_s = time.time() - T_START
    done = train.window(tr, pool, gen, first, args.seconds, check=(got, state))
    rate = done.steps * pool[0].images.shape[0] / done.seconds
    host_ms = sum(done.host_s) / len(done.host_s) * 1e3
    print(f"training: steps {done.steps} seconds {done.seconds!r} train_img_per_s {rate!r} host_call_ms {host_ms!r} "
          f"loss_first {done.losses[0]!r} loss_last {done.losses[-1]!r}", file=sys.stderr)
    trace, metrics, breakdown = None, None, None
    if args.trace:
        train.wrap_spans(tr)
        n = int(mix["trace_steps"])
        def stretch_trace():
            with Profile(train.SPANS) as prof:
                train.window(tr, pool, gen, first + done.steps, 0.0, spans=True, max_steps=n)
            return prof.trace(n)

        trace = _complete(stretch_trace)
        r = LayerReadings("train", trace, host_ms, {"train_img_per_s": rate}, cfg, pool[0].images.shape[1],
                          pool[0].images.shape[0])
        metrics = read_all(cell.per_layer, r)
        breakdown = {"device_ops": trace.top_families(), "idle_gaps": trace.idle_gaps()}
    dev = _device(device, trace)
    print(f"memory_peak_bytes {dev['memory_peak_bytes']}", file=sys.stderr)
    del tr
    _free(device)
    t0 = time.perf_counter()
    ref = train.reference_readings(cfg, mix, state, pool, args.seed, len(got.losses))
    print(f"check took {time.perf_counter() - t0:.3f} s over {len(got.losses)} steps", file=sys.stderr)
    print(f"losses {got.losses!r} reference {ref.losses!r}", file=sys.stderr)
    print("worst leaves (system/reference): " + train.worst_leaves(got, ref), file=sys.stderr)
    found = train.compare(got, ref, cfg["train"]["bn_momentum"])
    print("check, printed only: " + " ".join(f"{k} {v!r}" for k, v in found.items() if k not in train.COMPARED),
          file=sys.stderr)
    numbers = {k: found[k] for k in train.COMPARED}
    numbers["failed_steps"] = float(done.failed + (len(got.losses) != first + 1))
    if metrics is None:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}, "train_img_per_s": {"value": rate, "unit": "img/s"}}
    checks = _checks(numbers, limits)
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()), "attempted": done.steps,
              "failed": done.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


if __name__ == "__main__":
    main()
