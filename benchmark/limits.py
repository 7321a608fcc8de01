"""The readings a cell's limits are set from, in one process on the card:
the system's numbers on many seeds (each with its own set-up and a short
window at the cell's load, compared as a run compares it), each planted
fault's (serving: a stale answer, a class one off, boxes one rank off;
training: half of each batch left out, the mean taken over the rest), and
the control's on a few seeds (the plain reference computed in float8 e4m3,
the precision below the configuration's bf16, put in the system's place).

    python3 -m benchmark.limits --workload <cell> --seeds 11,12,... --control-seeds 21,22,23 [--seconds 2]

One JSON line a reading. The limit of each number in `workloads/<cell>.json`
lies between the largest reading of the system and the smallest of the
control or a fault (PERF.md gives the readings and the limits). The
benchmark's runs never call this.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch


def _emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _free() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _faults(served: dict, n_pool: int, nc: int) -> dict:
    """The planted faults, each applied to the kept requests' detections
    where the system produced them: a stale answer (each request given the
    previous kept request's detections, where that served another batch), a
    class one off (class + 1), and boxes one rank off (each detection given
    the box of the next)."""
    order = sorted(served)
    stale = {n: served[m] for n, m in zip(order, [order[0]] + order) if (n - m) % n_pool}
    cls = {n: (np.concatenate([d[..., :5], (d[..., 5:] + 1) % nc], -1), num) for n, (d, num) in served.items()}
    box = {n: (np.concatenate([np.roll(d[..., :4], -1, axis=1), d[..., 4:]], -1), num)
           for n, (d, num) in served.items()}
    return {"fault_stale": stale, "fault_class_next": cls, "fault_box_next_rank": box}


def serve_readings(cell, seeds, control_seeds, seconds: float) -> None:
    from . import generate as G
    from . import serve

    cfg, mix = cell.config, cell.traffic
    dev = torch.device("cuda")
    for seed in seeds:
        pred, pool, state, ring = serve.setup(cfg, mix, seed, dev)
        served = serve.window(pred, pool, ring, seconds, G.Reservoir(seed, int(mix["check_requests"])))
        del pred
        _free()
        _emit(kind="program", seed=seed, requests=len(served.kept), **serve.check(cfg, state, pool, served.kept))
        for kind, kept in _faults(served.kept, pool.shape[0], cfg["nc"]).items():
            _emit(kind=kind, seed=seed, requests=len(kept), **serve.check(cfg, state, pool, kept))
        del pool, state
        _free()
    for seed in control_seeds:
        state = G.make_state(cfg, seed, dev)
        pool = G.serve_pool(mix, cfg, seed, dev)
        images = pool.flatten(0, 1)
        G.calibrate_state(cfg, state, images[:: max(1, images.shape[0] // 8)][:8])
        _emit(kind="control_fp8", seed=seed, **serve.control(cfg, state, pool))
        del pool, state
        _free()


def train_readings(cell, seeds, control_seeds, fp32_seeds=()) -> None:
    from . import generate as G
    from . import train

    cfg, mix = cell.config, cell.traffic
    dev = torch.device("cuda")
    steps = int(mix["setup_steps"])
    for seed in seeds:
        t0 = time.perf_counter()
        tr, pool, state, got, gen = train.setup(cfg, mix, seed, dev)
        train.window(tr, pool, gen, steps, 0.0, max_steps=1, check=(got, state))
        del tr
        _free()
        ref = train.reference_readings(cfg, mix, state, pool, seed, steps + 1)
        _emit(kind="program", seed=seed, seconds=time.perf_counter() - t0, losses=got.losses, ref_losses=ref.losses,
              leaves=train.worst_leaves(got, ref), bn_gaps=train.bn_gaps(got, ref, cfg["train"]["bn_momentum"]),
              **train.compare(got, ref, cfg["train"]["bn_momentum"]))
        del pool, state
        _free()
    fp32 = {**cfg, "train": {**cfg["train"], "dtype": "float32", "remat": "full"}}  # fp32 fits only recomputed
    for seed in fp32_seeds:  # a second witness: the system's own fp32 path against the reference
        tr, pool, state, got, gen = train.setup(fp32, mix, seed, dev)
        train.window(tr, pool, gen, steps, 0.0, max_steps=1, check=(got, state))
        del tr
        _free()
        ref = train.reference_readings(cfg, mix, state, pool, seed, steps + 1)
        _emit(kind="system_fp32", seed=seed, losses=got.losses, ref_losses=ref.losses,
              leaves=train.worst_leaves(got, ref), **train.compare(got, ref, cfg["train"]["bn_momentum"]))
        del pool, state
        _free()
    for seed in control_seeds:
        state = G.make_state(cfg, seed, dev)
        pool = G.train_pool(mix, cfg, seed, dev)
        ref = train.reference_readings(cfg, mix, state, pool, seed, steps + 1)
        for kind, kw in (("control_fp8", {"quant": "fp8"}), ("fault_half_batch", {"half_batch": True})):
            other = train.reference_readings(cfg, mix, state, pool, seed, steps + 1, **kw)
            _emit(kind=kind, seed=seed, losses=other.losses, ref_losses=ref.losses, leaves=train.worst_leaves(other, ref),
                  bn_gaps=train.bn_gaps(other, ref, cfg["train"]["bn_momentum"]),
                  **train.compare(other, ref, cfg["train"]["bn_momentum"]))
        del pool, state
        _free()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="the system's seeds, comma-separated")
    p.add_argument("--control-seeds", default="", help="the control's and the faults' seeds, comma-separated")
    p.add_argument("--seconds", type=float, default=2.0, help="a serving cell's window a seed")
    p.add_argument("--fp32-seeds", default="", help="a training cell: seeds of the system's fp32 path (a witness)")
    args = p.parse_args(argv)
    from .spec import load_cell

    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    if cell.traffic["kind"] == "serve":
        serve_readings(cell, seeds, controls, args.seconds)
    else:
        train_readings(cell, seeds, controls, [int(s) for s in args.fp32_seeds.split(",") if s])


if __name__ == "__main__":
    main()
