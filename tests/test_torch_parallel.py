"""The port's data parallelism (`leanyolo_tpu_torch/parallel/`,
`Trainer(mesh=)`, `Predictor(mesh=)`, `validate_coco(mesh=, shard=)`) on two
gloo CPU ranks, against the port's one-process runs and the JAX package.

The ranks are two processes that run this file as a script (`_worker`, at
the bottom): they import the port only, take one thread each, run every
scenario once under one timeout and save what they saw; each test reads its
part. JAX runs in the pytest process on its virtual CPU devices
(tests/conftest.py), while the ranks run.

Model and data: yolov10n (4 classes) from JAX's seed 0 with randomized BN
statistics, at 96 px (at 64 px the deepest batch-stat BNs amplify fp32
summation order: test_torch_train.py), global batch 4 (2 a rank) of
full-range noise with 6 GT slots.

Tolerances:
- data-parallel against one process, both the port on the same global
  batch and the same augmentation draws (they differ only in the order of
  fp32 sums: per-rank partial sums, then the all-reduce), with
  test_torch_train.py's tolerances: losses within 1e-5 relative; each
  parameter's gradient within 1e-3 of that tensor's max|g| (a tensor whose
  gradient is rounding noise, under 1e-4 of the largest, only under it on
  both sides); BN running statistics within 5e-4 of max(1, scale). At this
  size the batch-stat BNs amplify the order of the sums: the gradients
  measured up to 1.94e-4 of their scale apart (the chip's check at 640 px
  holds 1e-4);
- against JAX's `Trainer(mesh=make_mesh(2))`: test_torch_train.py's
  whole-step tolerances, losses within 1e-4 relative and BN running
  statistics within 5e-4 of max(1, scale), at lr 1e-4, with augmentation
  on at p_hflip 1 and p_bc 0 (the packages draw different random numbers;
  at these probabilities the draws decide nothing);
- the ranks: bit-equal parameters and statistics after every step;
- a hybrid (dcn, data) mesh: bit-equal to the flat mesh (the same group);
- `remat="full"`: bit-equal to `"none"` (the recompute's all-reduces give
  the forward's sums; the statistics advance once).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

S, B, N, NC = 96, 4, 6, 4
NAMES = [f"c{i}" for i in range(NC)]
WORLD = 2
#: Train runs of the ranks: the TrainConfig, the mesh, the steps.
FREEZE = dict(augment=True, p_hflip=1.0, p_bc=0.0, grad_clip=1.0, lr=1e-4, freeze_backbone=True, unfreeze_epoch=1,
              steps_per_epoch=1, epochs=3)
AUGMENT = dict(augment=True, grad_clip=1.0, lr=1e-4, steps_per_epoch=1000)
RUNS = {
    "freeze": (FREEZE, "flat", 2),  # step 1 frozen, step 2 unfrozen
    "freeze_remat": (dict(FREEZE, remat="full"), "flat", 2),
    "augment": (AUGMENT, "flat", 1),  # random flips and jitter, drawn for the global batch
    "hybrid": (AUGMENT, "hybrid", 1),
}
VAL_IMAGES, VAL_BATCH = 6, 4
SEED = 7  # the augmentation generator's


def _batch(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(0, S - 26, (2, B, N))
    wh = rng.uniform(6, 24, (2, B, N))
    boxes = np.stack([x1, y1, x1 + wh[0], y1 + wh[1]], axis=-1).astype(np.float32)
    mask = rng.uniform(size=(B, N)) < 0.7
    mask[:, 0] = True
    return {"images": rng.randint(0, 256, (B, S, S, 3)).astype(np.uint8),
            "gt_labels": rng.randint(0, NC, (B, N)).astype(np.int32), "gt_boxes": boxes, "gt_mask": mask}


def _host_batch(d: dict, rows=slice(None)):
    from leanyolo_tpu_torch.data.dataset import Batch

    return Batch(*(np.asarray(d[k])[rows] for k in ("images", "gt_labels", "gt_boxes", "gt_mask")),
                 [None] * len(np.asarray(d["images"])[rows]))


def _train(model, cfg: dict, batches, mesh=None, rows=slice(None)) -> list:
    """Steps of a Trainer on `batches` -> per step the losses, the gradients
    (before the clip) and the state after the optimizer."""
    from leanyolo_tpu_torch import TrainConfig, Trainer

    tr = Trainer(model, TrainConfig(**cfg), mesh=mesh, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    out = []
    for d in batches:
        losses = tr.forward_backward(_host_batch(d, rows), gen)
        grads = {n: None if p.grad is None else p.grad.clone() for n, p in model.named_parameters()}
        tr.optimizer_step()
        tr.global_step += 1
        out.append({"losses": {k: float(v) for k, v in losses.items()}, "grads": grads,
                    "state": {k: v.clone() for k, v in model.state_dict().items()}})
    return out


def _bn_case(rows=slice(None)):
    """A ConvBNAct on rows of one seeded input, a weighted sum of its output
    as the loss -> (output, input gradient, parameter gradients, state)."""
    from leanyolo_tpu_torch.models.yolov10.layers import ConvBNAct

    g = torch.Generator().manual_seed(3)
    m = ConvBNAct(8, 16, 3, generator=g).train()
    x = torch.randn(4, 8, 6, 6, generator=g)[rows].requires_grad_()
    w = torch.randn(4, 16, 6, 6, generator=g)[rows]
    y = m(x)
    (y * w).sum().backward()
    return y.detach(), x.grad, {n: p.grad for n, p in m.named_parameters()}, m.state_dict()


# --------------------------------------------------------------------------- the pytest side


def _ranks(root: str) -> list:
    from leanyolo_tpu_torch.parallel.distributed import free_port
    from leanyolo_tpu_torch.parallel.dryrun import check_ranks, spawn_ranks

    port = free_port()
    results = spawn_ranks(lambda r: [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world",
                                     str(WORLD), "--port", str(port), "--root", root], WORLD, timeout=300)
    check_ranks(results, "the data-parallel ranks")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True) for r in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results beside the one-process and JAX references."""
    import jax

    from leanyolo_tpu.data.dataset import Batch as JBatch
    from leanyolo_tpu.engine import trainer as JTr
    from leanyolo_tpu.parallel.mesh import make_mesh as jmake_mesh
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.data.dataset import CocoDetection
    from leanyolo_tpu_torch.engine.validator import validate_coco
    from leanyolo_tpu_torch.models.yolov10.convert import export_jax_params, flatten_param_paths
    from synth_coco import make_synth_coco
    from torch_parity import calibrated_model, jax_and_port_models, self_labels

    root = str(tmp_path_factory.mktemp("parallel"))
    jm, tm = jax_and_port_models("yolov10n", NC, 0)
    batches = [_batch(1), _batch(2)]

    # The validation set, labelled by the one-process run of a calibrated model.
    img_dir, ann = make_synth_coco(os.path.join(root, "coco"), n_images=VAL_IMAGES)
    ds = CocoDetection(img_dir, ann, img_size=S)
    vm = calibrated_model(3, np.stack([ds[i][0] for i in range(len(ds))]))
    blank = os.path.join(root, "blank.json")
    with open(ann) as f:
        gt = dict(json.load(f), annotations=[])
    with open(blank, "w") as f:
        json.dump(gt, f)
    vkw = dict(images_dir=img_dir, imgsz=S, batch_size=VAL_BATCH, workers=1, device="cpu")
    dets = os.path.join(root, "dets.json")
    validate_coco(vm, ann_json=blank, save_detections=dets, **vkw)
    with open(dets) as f:
        gt["annotations"] = self_labels(json.load(f), [im["id"] for im in gt["images"]])
    labelled = os.path.join(root, "labelled.json")
    with open(labelled, "w") as f:
        json.dump(gt, f)

    torch.save({"state": tm.state_dict(), "val_state": vm.state_dict(), "images_dir": img_dir, "ann_json": labelled,
                "batches": [{k: torch.from_numpy(v) for k, v in d.items()} for d in batches]},
               os.path.join(root, "inputs.pt"))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_ranks, root)

        ref = {"val": validate_coco(vm, ann_json=labelled, **vkw)}
        for name in ("freeze", "augment"):
            model = YOLOv10.create("yolov10n", class_names=NAMES)
            model.load_state_dict(tm.state_dict())
            ref[name] = _train(model, RUNS[name][0], batches)
        ref["bn"] = _bn_case()
        from leanyolo_tpu_torch import Predictor

        images = batches[0]["images"]
        ref["topk"] = Predictor(tm, imgsz=S, decode="topk", device="cpu").run_batch(images)
        ref["nms"] = Predictor(tm, imgsz=S, decode="nms", conf_thresh=0.01, class_wise_nms=True,
                               device="cpu").run_batch(images)

        jt = JTr.Trainer(jm, JTr.TrainConfig(**FREEZE), mesh=jmake_mesh(WORLD))
        jax_steps = []
        for i, d in enumerate(batches):
            jl = jt.train_step(JBatch(*(d[k] for k in ("images", "gt_labels", "gt_boxes", "gt_mask")), [None] * B),
                               jax.random.PRNGKey(i))
            jax_steps.append({"losses": {k: float(v) for k, v in jl.items()},
                              "stats": {p: np.asarray(v) for p, v in flatten_param_paths(jm.params)
                                        if p[-1] in ("mean", "var")}})
        ref["jax"] = jax_steps
        got = ranks.result()

    def jax_paths(state):
        model = YOLOv10.create("yolov10n", class_names=NAMES)
        model.load_state_dict(state)
        return dict(flatten_param_paths(export_jax_params(model)))

    return {"ranks": got, "ref": ref, "jax_paths": jax_paths}


def _grads_close(got: dict, ref: dict, tol: float) -> None:
    gmax = max(float(g.abs().max()) for g in ref.values() if g is not None)
    assert [k for k, g in got.items() if g is None] == [k for k, g in ref.items() if g is None]
    for k, g in ref.items():
        if g is None:
            continue
        scale = float(g.abs().max())
        if scale <= 1e-4 * gmax:
            assert float(got[k].abs().max()) <= 1e-4 * gmax, k
        else:
            assert float((got[k] - g).abs().max()) <= tol * scale, k


def _stats_close(got: dict, ref: dict, tol: float) -> None:
    keys = [k for k in ref if "running" in k]
    assert keys
    for k in keys:
        assert float((got[k] - ref[k]).abs().max()) <= tol * max(1.0, float(ref[k].abs().max())), k


@pytest.mark.parametrize("name", ["freeze", "freeze_remat", "augment"])
def test_data_parallel_steps_match_one_process(run, name):
    """Each step's global losses, summed gradients and BN statistics equal
    the one-process step's on the global batch; the frozen step leaves the
    backbone and neck without gradients on every rank."""
    ref = run["ref"]["augment" if name == "augment" else "freeze"]
    for r, steps in enumerate(run["ranks"]):
        for i, (got, want) in enumerate(zip(steps["train"][name], ref)):
            for k, v in want["losses"].items():
                assert abs(got["losses"][k] - v) <= 1e-5 * abs(v), (r, i, k)
            _grads_close(got["grads"], want["grads"], 1e-3)
            _stats_close(got["state"], want["state"], 5e-4)
    if name != "augment":
        frozen = run["ranks"][0]["train"][name][0]["grads"]
        assert frozen["backbone.cv0.conv.weight"] is None and frozen["neck.p3_down.conv.weight"] is None
        assert frozen["head.cv2.0.2.weight"] is not None
        assert run["ranks"][0]["train"][name][1]["grads"]["backbone.cv0.conv.weight"] is not None


@pytest.mark.parametrize("name", ["freeze", "freeze_remat"])
def test_data_parallel_steps_match_jax_mesh(run, name):
    """Across the unfreeze boundary, the port's data-parallel steps against
    JAX's Trainer(mesh=make_mesh(2)) on the same global batches (JAX's
    checkpointed step computes what its plain step computes)."""
    for i, want in enumerate(run["ref"]["jax"]):
        got = run["ranks"][0]["train"][name][i]
        for k, v in want["losses"].items():
            assert abs(got["losses"][k] - v) <= 1e-4 * abs(v), (i, k)
        paths = run["jax_paths"](got["state"])
        for p, ref in want["stats"].items():
            assert np.max(np.abs(paths[p] - ref)) <= 5e-4 * max(1.0, np.max(np.abs(ref))), (i, p)


def test_ranks_hold_identical_state_and_remat_changes_nothing(run):
    r0, r1 = (rk["train"] for rk in run["ranks"])
    for name in RUNS:
        for a, b in zip(r0[name], r1[name]):
            assert a["losses"] == b["losses"], name
            assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"]), name
    for a, b in zip(r0["freeze"], r0["freeze_remat"]):
        assert a["losses"] == b["losses"]
        assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"] if "running" in k)
        assert all((g is None and b["grads"][k] is None) or torch.equal(g, b["grads"][k])
                   for k, g in a["grads"].items())


def test_hybrid_mesh_step_equals_flat(run):
    for rk in run["ranks"]:
        assert rk["hybrid_shape"] == [2, 1]
        flat, hybrid = rk["train"]["augment"][0], rk["train"]["hybrid"][0]
        assert flat["losses"] == hybrid["losses"]
        assert all(torch.equal(flat["state"][k], hybrid["state"][k]) for k in flat["state"])


def test_batchnorm_takes_the_global_batch_statistics(run):
    """A ConvBNAct on two ranks' halves of a batch: each rank's output and
    input gradient are its rows of the whole batch's, the parameter
    gradients sum to the whole batch's, the running statistics are the
    whole batch's on both."""
    y, gx, gp, state = run["ref"]["bn"]
    for r, rk in enumerate(run["ranks"]):
        rows = slice(2 * r, 2 * r + 2)
        ry, rgx, _, rstate = rk["bn"]
        assert float((ry - y[rows]).abs().max()) <= 1e-5 * float(y.abs().max())
        assert float((rgx - gx[rows]).abs().max()) <= 1e-5 * float(gx.abs().max())
        _stats_close(rstate, state, 1e-6)
    for k, g in gp.items():
        total = run["ranks"][0]["bn"][2][k] + run["ranks"][1]["bn"][2][k]
        assert float((total - g).abs().max()) <= 1e-5 * float(g.abs().max()), k


@pytest.mark.parametrize("decode", ["topk", "nms"])
def test_predictor_mesh_equals_the_plain_predictor(run, decode):
    dets, num = run["ref"][decode]
    for rk in run["ranks"]:
        gd, gn = rk["predict"][decode]
        assert torch.equal(gn, num)
        np.testing.assert_allclose(gd.numpy(), dets.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["mesh", "shard"])
def test_validate_coco_mesh_and_shard_equal_one_process(run, mode):
    want = run["ref"]["val"]
    assert want["map_50_95"] > 0.5 and want["n_images"] == VAL_IMAGES
    stats = [rk["val"][mode] for rk in run["ranks"]]
    if mode == "shard":
        assert stats[0] == stats[1]  # process 0's answer, wall time included
    for got in stats:
        assert got["n_images"] == VAL_IMAGES
        for k in ("map_50_95", "map_50", "map_75", "map_small", "map_medium", "map_large"):
            assert abs(got[k] - want[k]) <= 1e-9, (mode, k, got[k], want[k])


def test_shard_image_list_matches_jax():
    from leanyolo_tpu.parallel import distributed as JD
    from leanyolo_tpu_torch.parallel import distributed as TD

    for n in (1, 7, 8, 13):
        items = [{"id": i} for i in range(n)]
        for nprocs in (1, 2, 3, 8):
            for pid in range(nprocs):
                if n // nprocs == 0:
                    with pytest.raises(ValueError):
                        TD.shard_image_list(items, pid, nprocs)
                    with pytest.raises(ValueError):
                        JD.shard_image_list(items, pid, nprocs)
                else:
                    assert TD.shard_image_list(items, pid, nprocs) == JD.shard_image_list(items, pid, nprocs)


def test_process_local_slice_and_allgather_obj_match_jax(run, monkeypatch):
    """The ranks' process_local_slice and allgather_obj against JAX's
    functions told the same process count and index (and, for the gather,
    JAX's JSON round trip); one process: the object itself. Each rank's
    shard_batch holds its rows; every axis of a data-parallel mesh carries
    the batch."""
    from types import SimpleNamespace

    from leanyolo_tpu.parallel import distributed as JD
    from leanyolo_tpu_torch.parallel import distributed as TD

    objs = [json.loads(json.dumps({"rank": r, "pair": (r, "x"), "f": 0.1 * r})) for r in range(WORLD)]
    for r, rk in enumerate(run["ranks"]):
        monkeypatch.setattr(JD, "jax", SimpleNamespace(process_count=lambda: WORLD, process_index=lambda r=r: r))
        want = JD.process_local_slice(8)
        assert rk["fns"]["slice"] == [want.start, want.stop]
        assert rk["fns"]["gathered"] == objs
        assert rk["fns"]["rows"] == np.arange(8).reshape(4, 2)[2 * r:2 * r + 2].tolist()
        assert rk["fns"]["axes"] == [["data"], ["dcn", "data"]]
    monkeypatch.undo()
    obj = {"a": (1, 2)}
    assert TD.allgather_obj(obj) == JD.allgather_obj(obj) == [obj]
    assert TD.process_local_slice(6) == JD.process_local_slice(6) == slice(0, 6)


def test_init_distributed_reads_the_environment_as_jax(monkeypatch):
    """The same LEANYOLO_* variables (and explicit arguments over them) give
    JAX's jax.distributed.initialize and the port's init_process_group the
    same coordinator, process count and id; torchrun's variables also serve
    the port; with nothing configured both are a world of one."""
    import jax

    from leanyolo_tpu.parallel import distributed as JD
    from leanyolo_tpu_torch.parallel import distributed as TD

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: seen.__setitem__("jax", kw))
    monkeypatch.setattr(TD.dist, "init_process_group", lambda backend, **kw: seen.__setitem__("port", (backend, kw)))
    monkeypatch.setattr(TD.dist, "get_world_size", lambda: -1)
    for k in ("LEANYOLO_COORDINATOR", "LEANYOLO_NUM_PROCS", "LEANYOLO_PROC_ID", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)

    def both(*args):
        seen.clear()
        monkeypatch.setattr(JD, "_INITIALIZED", False)
        j, t = JD.init_distributed(*args), TD.init_distributed(*args, device="cpu")
        return j, t, seen.get("jax"), seen.get("port")

    j, t, jkw, pkw = both()
    assert (j, t, jkw, pkw) == (1, 1, None, None)
    monkeypatch.setenv("LEANYOLO_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("LEANYOLO_NUM_PROCS", "4")
    monkeypatch.setenv("LEANYOLO_PROC_ID", "3")
    for args, want in (((), ("10.0.0.1:1234", 4, 3)), (("h:9", 2, 1), ("h:9", 2, 1))):
        _, _, jkw, (backend, kw) = both(*args)
        assert (jkw["coordinator_address"], jkw["num_processes"], jkw["process_id"]) == want
        assert backend == "gloo" and (kw["init_method"], kw["world_size"], kw["rank"]) == (f"tcp://{want[0]}",
                                                                                            *want[1:])
    for k in ("LEANYOLO_COORDINATOR", "LEANYOLO_NUM_PROCS", "LEANYOLO_PROC_ID"):
        monkeypatch.delenv(k)
    for k, v in (("MASTER_ADDR", "n0"), ("MASTER_PORT", "29500"), ("WORLD_SIZE", "8"), ("RANK", "5")):
        monkeypatch.setenv(k, v)
    seen.clear()
    TD.init_distributed(device="cpu")
    backend, kw = seen["port"]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://n0:29500", 8, 5)


def test_dryrun_multichip_on_two_ranks(capsys):
    from leanyolo_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(2, timeout=300)
    assert line.startswith("dryrun_multichip(2) OK: loss=") and "nms_dets=(2, 300, 6)" in line
    assert capsys.readouterr().out.strip().endswith(line)


def test_devices_without_a_backend_or_a_card_raise():
    """A device with no process-group backend raises; without a card the
    card's NCCL group raises unless the CPU (gloo) is asked for; a space or
    model mesh that is not the job's process count raises with JAX's words
    and says what to start, before any process group is made."""
    import torch.distributed as dist

    from leanyolo_tpu_torch.parallel import distributed as TD
    from leanyolo_tpu_torch.parallel.mesh import make_sp_mesh, make_tp_mesh

    with pytest.raises(ValueError, match="backend"):
        TD.device_type("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TD.init_distributed(device="cuda")
    for make in (make_sp_mesh, make_tp_mesh):
        with pytest.raises(ValueError, match=r"requested 4 devices, have 1 .*torchrun --nproc-per-node=4"):
            make(2, 2, device="cpu")
    assert not dist.is_initialized()


# --------------------------------------------------------------------------- the ranks


def _worker(argv) -> None:
    p = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--root", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)

    import torch.distributed as dist

    from leanyolo_tpu_torch import Predictor, YOLOv10
    from leanyolo_tpu_torch.engine.validator import validate_coco
    from leanyolo_tpu_torch.models.yolov10.layers import global_batch_stats
    from leanyolo_tpu_torch.parallel.distributed import (allgather_obj, init_distributed, process_local_slice,
                                                         warmup_collectives)
    from leanyolo_tpu_torch.parallel.mesh import data_axis_names, make_hybrid_mesh, make_mesh, shard_batch

    init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank, device="cpu")
    inputs = torch.load(os.path.join(args.root, "inputs.pt"), weights_only=True)
    batches = [{k: v.numpy() for k, v in d.items()} for d in inputs["batches"]]
    rows = process_local_slice(B)
    flat = make_mesh(device="cpu")
    hybrid = make_hybrid_mesh(device="cpu")
    out = {"hybrid_shape": list(hybrid.shape), "train": {}}

    def model(state, names=NAMES):
        m = YOLOv10.create("yolov10n", class_names=names)
        m.load_state_dict(state)
        return m

    for name, (cfg, kind, steps) in RUNS.items():
        out["train"][name] = _train(model(inputs["state"]), cfg, batches[:steps],
                                    mesh=flat if kind == "flat" else hybrid, rows=rows)

    with global_batch_stats(dist.group.WORLD):
        y, gx, gp, state = _bn_case(slice(2 * args.rank, 2 * args.rank + 2))
    out["bn"] = (y, gx, gp, state)

    images = batches[0]["images"]
    tm = model(inputs["state"])
    out["predict"] = {
        "topk": Predictor(tm, imgsz=S, decode="topk", device="cpu", mesh=flat).run_batch(images),
        "nms": Predictor(tm, imgsz=S, decode="nms", conf_thresh=0.01, class_wise_nms=True, device="cpu",
                         mesh=flat).run_batch(images),
    }

    vm = model(inputs["val_state"], [f"class{c}" for c in range(3)])
    vkw = dict(images_dir=inputs["images_dir"], ann_json=inputs["ann_json"], imgsz=S, batch_size=VAL_BATCH,
               workers=1, device="cpu")
    out["val"] = {"mesh": validate_coco(vm, mesh=flat, **vkw),
                  "shard": validate_coco(vm, shard=(args.rank, args.world), **vkw)}

    sl = process_local_slice(8)
    warmup_collectives(hybrid)
    out["fns"] = {"slice": [sl.start, sl.stop],
                  "gathered": allgather_obj({"rank": args.rank, "pair": (args.rank, "x"), "f": 0.1 * args.rank}),
                  "rows": shard_batch(flat, np.arange(8).reshape(4, 2)).tolist(),
                  "axes": [list(data_axis_names(m)) for m in (flat, hybrid)]}
    torch.save(out, os.path.join(args.root, f"rank{args.rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _worker(sys.argv[1:])
