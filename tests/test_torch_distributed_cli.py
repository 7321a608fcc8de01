"""The port's CLIs data-parallel: `train`, `transfer_learn` and `val` under
--distributed with two gloo processes on the CPU (`--device cpu`), their
parsers against the JAX CLIs', and the options not ported.

Each run starts two processes that run this file as a script (`_worker`, at
the bottom): a rank imports the port only, takes one thread, runs the CLI's
`main` with --distributed --coordinator 127.0.0.1:<port> --num-processes 2
--process-id <rank>, and saves the weights its trainer ended with. Data:
`torch_parity.make_mixed_coco`'s 8 images at mixed sizes, yolov10n at 64 px,
global batch 4 (2 a process).

What is held:
- process 0 alone writes the checkpoints, history.jsonl (one row an epoch),
  train.log and the CSV row; both processes end with bit-equal weights;
- a distributed run stopped after epoch 2 and resumed equals the
  uninterrupted 3-epoch run bit for bit (every array of last.npz);
- the transfer CLI keeps the backbone frozen for epoch 1 and logs UNFREEZE,
  a VAL line each epoch and best.npz, from process 0;
- `val --distributed --data-parallel 2` (a shard of the images a process,
  each on a mesh of itself, one allgather) prints the one-process CLI's mAP
  line on both processes, on a set
  labelled by the model's own detections (so the mAP is not 0);
- each CLI's parser gives JAX's namespace for the same argv;
- --spatial-parallel and --tensor-parallel raise, naming ROADMAP.md Queue 1
  item 7; --data-parallel without a card raises unless --device cpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

COMMON = ["--model", "yolov10n", "--imgsz", "64", "--batch-size", "4", "--max-boxes", "8", "--workers", "2"]


def _run(module: str, argv: list, root: str, tag: str) -> list:
    """`module`'s main on two gloo processes -> each rank's (stdout, final
    trainer state or None)."""
    from leanyolo_tpu_torch.parallel.distributed import free_port
    from leanyolo_tpu_torch.parallel.dryrun import check_ranks, spawn_ranks

    port = free_port()
    states = [os.path.join(root, f"{tag}_rank{r}.pt") for r in range(2)]
    results = spawn_ranks(
        lambda r: [sys.executable, os.path.abspath(__file__), module, states[r], *argv, "--device", "cpu",
                   "--distributed", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                   "--process-id", str(r)], 2, timeout=300)
    check_ranks(results, f"{module} --distributed")
    return [(out, torch.load(p, weights_only=True) if os.path.exists(p) else None)
            for (_, out, _), p in zip(results, states)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from torch_parity import make_mixed_coco

    root = tmp_path_factory.mktemp("dist_cli")
    img_dir, ann = make_mixed_coco(str(root / "data"), n_images=8)
    data = ["--train-images", img_dir, "--train-ann", ann, "--val-images", img_dir, "--val-ann", ann]
    base = COMMON + data + ["--augment", "--preprocess", "device", "--log-interval", "1"]
    full, part = str(root / "full"), str(root / "part")
    out = {"root": root, "data": (img_dir, ann), "full": full, "part": part}
    out["train"] = _run("train", base + ["--epochs", "3", "--out-dir", full], str(root), "full")
    _run("train", base + ["--epochs", "2", "--out-dir", part], str(root), "part")
    out["resume"] = _run("train", base + ["--epochs", "3", "--out-dir", part, "--resume"], str(root), "resume")
    return out


def _history(run_dir):
    with open(os.path.join(run_dir, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_distributed_process0_writes_and_ranks_agree(runs):
    (out0, s0), (out1, s1) = runs["train"]
    assert s0 is not None and all(torch.equal(s0[k], s1[k]) for k in s0)
    rows = _history(runs["full"])
    assert [r["epoch"] for r in rows] == [1, 2, 3] and all(r["steps"] == 2 for r in rows)
    assert all(np.isfinite(r["map_50_95"]) for r in rows)  # process 0's evaluation
    assert "saved final checkpoint" in out0 and "saved final checkpoint" not in out1
    assert "mAP50-95=" in out0 and "mAP50-95=" not in out1
    assert "process 0/2" in out0 and "process 1/2" in out1
    # Both log the global losses.
    assert [l for l in out0.splitlines() if " total=" in l] == [l for l in out1.splitlines() if " total=" in l]
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.models.registry import load_checkpoint_into

    saved = YOLOv10.create("yolov10n", class_names=["rect", "circle", "triangle"])
    load_checkpoint_into(saved, os.path.join(runs["full"], "last.npz"))  # what process 0 wrote
    assert all(torch.equal(v, s0[k]) for k, v in saved.state_dict().items())


def test_train_distributed_resume_is_bit_exact(runs):
    (out0, s0), (_, s1) = runs["resume"]
    assert "resumed from" in out0 and "at epoch 2 (step 4)" in out0
    with np.load(os.path.join(runs["full"], "last.npz")) as a, np.load(os.path.join(runs["part"], "last.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    whole, resumed = _history(runs["full"]), _history(runs["part"])
    assert [r["epoch"] for r in resumed] == [1, 2, 3]
    for r, s in zip(whole, resumed):
        assert {k: v for k, v in r.items() if k not in ("time_s", "img_s")} == \
            {k: v for k, v in s.items() if k not in ("time_s", "img_s")}
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_transfer_learn_distributed(runs):
    img_dir, ann = runs["data"]
    out = runs["root"] / "transfer"
    argv = COMMON + ["--weights", os.path.join(runs["full"], "ckpt.npz"), "--train-images", img_dir, "--train-ann",
                     ann, "--val-images", img_dir, "--val-ann", ann, "--epochs", "2", "--unfreeze-epoch", "1",
                     "--no-amp", "--out-dir", str(out)]
    (out0, s0), (out1, s1) = _run("transfer_learn", argv, str(runs["root"]), "transfer")
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    log = (out / "train.log").read_text()
    for text in ("RUN START", "head reset to fresh random init", "EPOCH 1/2 loss=", "VAL epoch 1 mAP50-95=",
                 "UNFREEZE backbone at epoch 2", "EPOCH 2/2 loss=", "VAL epoch 2 mAP50-95=", "RUN END best"):
        assert log.count(text) == 1, text  # process 0's lines only
    assert (out / "best.npz").exists() and (out / "ckpt.npz").exists()
    with np.load(os.path.join(runs["full"], "ckpt.npz")) as s, np.load(out / "epoch001.npz") as e1:
        frozen = [k for k in s.files if k.split(".")[0] in ("backbone", "neck") and k.endswith("conv.weight")]
        assert frozen and all(np.array_equal(s[k], e1[k]) for k in frozen)


def test_val_distributed_equals_one_process(runs):
    from leanyolo_tpu_torch.tools import val
    from torch_parity import self_labels

    img_dir, ann = runs["data"]
    root = runs["root"]
    weights = os.path.join(runs["full"], "ckpt.npz")
    argv = ["--model", "yolov10n", "--weights", weights, "--images-dir", img_dir, "--imgsz", "64", "--workers", "2"]
    dets = str(root / "val_dets.json")
    with contextlib.redirect_stdout(io.StringIO()):
        val.main(argv + ["--ann-json", ann, "--batch-size", "4", "--save-detections", dets, "--device", "cpu",
                         "--log-csv", str(root / "label.csv")])
    with open(ann) as f:
        gt = json.load(f)
    with open(dets) as f:
        gt["annotations"] = self_labels(json.load(f), [im["id"] for im in gt["images"]])
    labelled = str(root / "labelled.json")
    with open(labelled, "w") as f:
        json.dump(gt, f)
    one = io.StringIO()
    with contextlib.redirect_stdout(one):
        val.main(argv + ["--ann-json", labelled, "--batch-size", "4", "--device", "cpu", "--log-csv",
                         str(root / "one.csv")])
    line = next(l for l in one.getvalue().splitlines() if l.startswith("mAP50-95="))
    assert float(line.split()[0].split("=")[1]) > 0.5 and "images=8" in line
    csv = str(root / "dist.csv")
    ranks = _run("val", argv + ["--ann-json", labelled, "--batch-size", "2", "--data-parallel", "2", "--log-csv",
                                csv], str(root), "val")
    for out, state in ranks:
        assert state is None
        got = next(l for l in out.splitlines() if l.startswith("mAP50-95="))
        assert got.split(" throughput=")[0] == line.split(" throughput=")[0]
    with open(csv) as f:
        assert len(f.read().strip().splitlines()) == 2  # the header and process 0's row


def _namespaces(port_parse, jax_module, argv):
    old = sys.argv
    sys.argv = ["prog", *argv]
    try:
        want = vars(jax_module.parse_args())
    finally:
        sys.argv = old
    got = vars(port_parse(argv))
    assert got.pop("device") == "cuda"
    return got, want


@pytest.mark.parametrize("cli", ["train", "transfer_learn", "val"])
def test_parsers_give_the_jax_namespaces(cli):
    import importlib

    jax_module = importlib.import_module(f"tools.{cli}")
    port = importlib.import_module(f"leanyolo_tpu_torch.tools.{cli}")
    data = {"train": ["--train-images", "a", "--train-ann", "b"],
            "transfer_learn": ["--train-images", "a", "--train-ann", "b", "--val-images", "c", "--val-ann", "d"],
            "val": ["--images-dir", "a", "--ann-json", "b"]}[cli]
    dp = ["--data-parallel", "2", "--spatial-parallel", "0", "--tensor-parallel", "0"] if cli == "val" \
        else ["--data-parallel"]
    for argv in (data, data + dp, data + ["--distributed", "--coordinator", "h:1", "--num-processes", "2",
                                          "--process-id", "1", "--batch-size", "8"]):
        got, want = _namespaces(port.parse_args, jax_module, argv)
        assert got == want, argv


def test_parallel_options_not_ported_raise(tmp_path):
    from leanyolo_tpu_torch.tools import infer, train, val

    for flag in ("--spatial-parallel", "--tensor-parallel"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            val.main(["--images-dir", str(tmp_path), "--ann-json", "none.json", "--device", "cpu", flag, "2"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        infer.main(["--source", str(tmp_path), "--device", "cpu", "--spatial-parallel", "2"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: --data-parallel runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--train-images", str(tmp_path), "--train-ann", "none.json", "--data-parallel"])


def _worker(argv) -> None:
    """argv: <cli module> <state file> <the CLI's arguments>."""
    import importlib

    torch.set_num_threads(1)
    import torch.distributed as dist

    from leanyolo_tpu_torch.engine import trainer as T

    module, state_path, cli_argv = argv[0], argv[1], argv[2:]
    made = []
    init = T.Trainer.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    T.Trainer.__init__ = keep
    importlib.import_module(f"leanyolo_tpu_torch.tools.{module}").main(cli_argv)
    if made:
        torch.save(made[-1].model.state_dict(), state_path)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1:])
