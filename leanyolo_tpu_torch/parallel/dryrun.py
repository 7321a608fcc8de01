"""A data-parallel dry run on CPU processes, and the launcher it uses.

`dryrun_multichip(n)` is the port's counterpart of `__graft_entry__.py::
dryrun_multichip`: it starts n gloo ranks on the CPU (one process each),
which take one data-parallel train step of yolov10n at 64 px (augmentation
and clip on, one image a rank), run a data-parallel top-k and a class-wise
NMS `Predictor` on the same global batch, and, with an even n >= 4, the
top-k `Predictor` on a (n/2, 2) space mesh and a (n/2, 2) model mesh, whose
detections must match the data-parallel ones to 1e-3, and the same step on
a (dcn, data) hybrid mesh, whose loss must equal the flat mesh's. It prints
one OK line.

Run it as `python -m leanyolo_tpu_torch.parallel.dryrun --n 2`.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[2]


def spawn_ranks(argv: Callable[[int], Sequence[str]], n: int, *, timeout: float,
                env: Optional[dict] = None) -> List[Tuple[int, str, str]]:
    """Run `argv(rank)` for rank 0..n-1 at once, each a process with this
    repository on its path; returns [(returncode, stdout, stderr)] by rank.

    When one rank fails the others are killed (they would wait on it in a
    collective), and so are all of them at `timeout` seconds; a killed
    rank's returncode is negative. Nothing is left running.
    """
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory() as tmp:
        files = [(open(os.path.join(tmp, f"{r}.out"), "w+"), open(os.path.join(tmp, f"{r}.err"), "w+"))
                 for r in range(n)]
        procs = []
        try:
            for r in range(n):
                procs.append(subprocess.Popen(list(argv(r)), stdout=files[r][0], stderr=files[r][1], env=env,
                                              cwd=str(ROOT)))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            out = []
            for (fo, fe), p in zip(files, procs):
                fo.seek(0)
                fe.seek(0)
                out.append((p.returncode, fo.read(), fe.read()))
                fo.close()
                fe.close()
    return out


def check_ranks(results: List[Tuple[int, str, str]], what: str) -> None:
    """Raise with every rank's output unless all exited 0."""
    if any(rc != 0 for rc, _, _ in results):
        report = "\n".join(f"--- rank {r}: exit {rc}\n{out[-4000:]}\n{err[-4000:]}"
                           for r, (rc, out, err) in enumerate(results))
        raise RuntimeError(f"{what}: a rank failed or timed out (a negative exit is a kill)\n{report}")


def _rank_main(rank: int, world: int, port: int) -> None:
    import numpy as np
    import torch

    from ..data.dataset import Batch
    from ..engine.predictor import Predictor
    from ..engine.trainer import TrainConfig, Trainer
    from ..models.yolov10.model import YOLOv10
    from .distributed import init_distributed, process_local_slice
    from .mesh import make_hybrid_mesh, make_mesh, make_sp_mesh, make_tp_mesh

    torch.set_num_threads(1)
    if init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu") != world:
        raise RuntimeError("the process group has another size")
    mesh = make_mesh(device="cpu")
    names = [f"c{i}" for i in range(4)]
    cfg = TrainConfig(epochs=1, steps_per_epoch=1, augment=True, grad_clip=1.0)

    b = world  # one image a rank
    rng = np.random.RandomState(0)
    images = rng.uniform(0, 255, (b, 64, 64, 3)).astype(np.float32)
    labels = np.zeros((b, 8), np.int32)
    boxes = np.tile(np.asarray([4, 4, 30, 30], np.float32), (b, 8, 1))
    mask = np.concatenate([np.ones((b, 2), bool), np.zeros((b, 6), bool)], axis=1)
    rows = process_local_slice(b)
    local = Batch(images[rows], labels[rows], boxes[rows], mask[rows], [None] * (rows.stop - rows.start))

    def step(m):
        model = YOLOv10.create("yolov10n", class_names=names, seed=0)
        total = float(Trainer(model, cfg, mesh=m, device="cpu").train_step(local, torch.Generator().manual_seed(0))
                      ["total"])
        if not np.isfinite(total):
            raise RuntimeError(f"non-finite loss: {total}")
        return total, model

    total, model = step(mesh)
    pred = Predictor(model, imgsz=64, decode="topk", device="cpu", mesh=mesh)
    dets, num = pred.run_batch(images)
    if dets.shape[0] != b or not bool(torch.isfinite(dets[..., 4]).all()):
        raise RuntimeError(f"top-k detections {tuple(dets.shape)}")
    npred = Predictor(model, imgsz=64, decode="nms", conf_thresh=0.01, class_wise_nms=True, device="cpu", mesh=mesh)
    ndets, nnum = npred.run_batch(images)
    if ndets.shape[0] != b or not bool(torch.isfinite(ndets[..., 4]).all()) or int(nnum.min()) < 0:
        raise RuntimeError(f"NMS detections {tuple(ndets.shape)}")

    # Spatial and tensor parallel legs: the same detections as the data-parallel forward.
    sp_ok = tp_ok = False
    if world % 2 == 0 and world >= 4:
        for make in (make_sp_mesh, make_tp_mesh):
            xdets, _ = Predictor(model, imgsz=64, decode="topk", device="cpu",
                                 mesh=make(world // 2, 2, device="cpu")).run_batch(images)
            if not torch.allclose(dets, xdets, rtol=1e-3, atol=1e-3):
                raise RuntimeError(f"{make.__name__}({world // 2}, 2) detections differ from the data-parallel "
                                   f"ones by {float((dets - xdets).abs().max())}")
        sp_ok = tp_ok = True

    hybrid = None
    if world % 2 == 0 and world >= 4:
        hybrid, _ = step(make_hybrid_mesh(2, device="cpu"))
        if abs(hybrid - total) >= 1e-3 * max(1.0, abs(total)):
            raise RuntimeError(f"hybrid mesh loss {hybrid} against the flat mesh's {total}")
    if rank == 0:
        print(f"dryrun_multichip({world}) OK: loss={total:.4f} hybrid_loss={hybrid if hybrid is None else round(hybrid, 4)} "
              f"eval_dets={tuple(dets.shape)} nms_dets={tuple(ndets.shape)} sp={sp_ok} tp={tp_ok} processes={world} "
              f"backend=gloo",
              flush=True)


def dryrun_multichip(n: int, *, timeout: float = 600.0) -> str:
    """Run the dry run on n gloo CPU ranks; prints and returns the OK line."""
    from .distributed import free_port

    port = free_port()
    results = spawn_ranks(lambda r: [sys.executable, "-m", "leanyolo_tpu_torch.parallel.dryrun", "--rank", str(r),
                                     "--world", str(n), "--port", str(port)], n, timeout=timeout)
    check_ranks(results, f"dryrun_multichip({n})")
    line = next(l for l in results[0][1].splitlines() if " OK: " in l)
    print(line, flush=True)
    return line


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="data-parallel dry run on gloo CPU ranks")
    p.add_argument("--n", type=int, default=2, help="ranks to start")
    p.add_argument("--rank", type=int, default=None, help="(a started rank) its index")
    p.add_argument("--world", type=int, default=None)
    p.add_argument("--port", type=int, default=None)
    args = p.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n)
    else:
        _rank_main(args.rank, args.world, args.port)


if __name__ == "__main__":
    main()
