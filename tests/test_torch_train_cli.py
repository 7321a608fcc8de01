"""The port's training CLIs (`python -m leanyolo_tpu_torch.tools.train` and
`.transfer_learn`) on the CPU (`--device cpu`), driven in process as
tests/test_resume.py drives the JAX CLI: yolov10n at 64 px on an 8-image
mixed-size set, device letterboxing and augmentation on.

What is held:
- a run stopped after epoch 2 and resumed equals an uninterrupted 4-epoch
  run bit for bit (every array of `last.npz`, the history's losses);
- `history.jsonl` has the JAX CLI's keys and JAX's `tools/convergence_gate.py`
  reads it; checkpoints carry JAX's metadata (`epoch`);
- a port checkpoint loads into the JAX package (`load_checkpoint_into`) and
  gives the port's fp32 eval head maps within 5e-4 of max(1, scale);
- the transfer CLI starts from the train run's 3-class checkpoint on a
  2-class set (the class-dependent head leaves skipped and logged), keeps
  the backbone and neck frozen for epoch 1, logs UNFREEZE at epoch 2, a VAL
  line each epoch, and writes `best.npz` by mAP50-95;
- without a card both CLIs raise unless asked for the CPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.registry import load_checkpoint_into as jload_checkpoint_into
from leanyolo_tpu.models.registry import load_checkpoint_meta as jload_checkpoint_meta
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10, model_apply
from leanyolo_tpu_torch import get_model
from leanyolo_tpu_torch.tools import train, transfer_learn
from torch_parity import make_mixed_coco

JAX_HISTORY_KEYS = {"epoch", "loss_total", "loss_cls", "loss_reg", "steps", "time_s", "img_s", "map_50_95", "map_50"}


def _common(img_dir, ann):
    return ["--model", "yolov10n", "--train-images", img_dir, "--train-ann", ann, "--val-images", img_dir,
            "--val-ann", ann, "--imgsz", "64", "--batch-size", "4", "--max-boxes", "8", "--workers", "2",
            "--device", "cpu"]


def _run_train(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    img_dir, ann = make_mixed_coco(str(root / "data"), n_images=8)
    base = _common(img_dir, ann) + ["--augment", "--preprocess", "device", "--log-interval", "1"]
    full, part = str(root / "full"), str(root / "part")
    logs = {"full": _run_train(base + ["--epochs", "4", "--out-dir", full])}
    logs["part"] = _run_train(base + ["--epochs", "2", "--out-dir", part])
    logs["resume"] = _run_train(base + ["--epochs", "4", "--out-dir", part, "--resume"])
    return {"full": full, "part": part, "logs": logs, "data": (img_dir, ann), "root": root}


def _history(run_dir):
    with open(os.path.join(run_dir, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_resume_equals_the_uninterrupted_run(runs):
    assert "resumed from" in runs["logs"]["resume"] and "at epoch 2 (step 4)" in runs["logs"]["resume"]
    with np.load(os.path.join(runs["full"], "last.npz")) as a, np.load(os.path.join(runs["part"], "last.npz")) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    whole, resumed = _history(runs["full"]), _history(runs["part"])
    assert [r["epoch"] for r in resumed] == [1, 2, 3, 4]
    for r, s in zip(whole, resumed):
        assert {k: v for k, v in r.items() if k not in ("time_s", "img_s")} == \
            {k: v for k, v in s.items() if k not in ("time_s", "img_s")}
    state = torch.load(os.path.join(runs["part"], "train_state.pt"), weights_only=True)
    assert state["global_step"] == 8


def test_outputs_have_the_jax_cli_formats(runs):
    rows = _history(runs["full"])
    assert len(rows) == 4
    for r in rows:
        assert set(r) == JAX_HISTORY_KEYS
        assert all(np.isfinite(r[k]) for k in ("loss_total", "loss_cls", "loss_reg", "map_50_95"))
        assert r["steps"] == 2
    for e in range(1, 5):
        assert jload_checkpoint_meta(os.path.join(runs["full"], f"epoch{e:03d}.npz"))["epoch"] == e
    meta = jload_checkpoint_meta(os.path.join(runs["full"], "ckpt.npz"))
    assert "epoch" not in meta and meta["model_name"] == "yolov10n" and meta["class_names"] == ["rect", "circle",
                                                                                                  "triangle"]
    log = runs["logs"]["full"]
    assert "epoch 1/4 step 1/2 total=" in log and "epoch 4 mAP50-95=" in log and "saved final checkpoint" in log


def test_jax_convergence_gate_reads_the_history(runs):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    try:
        from convergence_gate import evaluate, loss_curve_stats
    finally:
        sys.path.pop(0)
    rows = _history(runs["full"])
    stats = loss_curve_stats(rows)
    assert stats["epochs"] == 4 and stats["first"] == rows[0]["loss_total"]
    lines, _ = evaluate(rows, None, backend="cpu")
    assert lines[0].startswith("loss arm: 4 epochs")


def test_port_checkpoint_loads_into_jax(runs):
    """epoch002.npz through JAX's strict reader: the same fp32 eval head maps
    as the port's model loaded from the file (5e-4 of max(1, scale))."""
    path = os.path.join(runs["full"], "epoch002.npz")
    names = ["rect", "circle", "triangle"]
    jm = JYOLOv10.create("yolov10n", class_names=names, seed=7)
    jload_checkpoint_into(jm, path)
    tm = get_model("yolov10n", weights=path, class_names=names).eval()
    x = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    ref = model_apply(jm.params, jnp.asarray(x, jnp.float32), jm.cfg, train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).float())
    for k in ref:
        for r, g in zip(ref[k], got[k]):
            r = np.asarray(r)
            assert np.max(np.abs(g.numpy() - r)) <= 5e-4 * max(1.0, np.max(np.abs(r))), k


def test_transfer_cli_freeze_unfreeze_and_best(runs):
    img_dir, ann = runs["data"]
    with open(ann) as f:
        gt = json.load(f)
    gt["categories"] = gt["categories"][:2]
    gt["annotations"] = [a for a in gt["annotations"] if a["category_id"] <= 2]
    two = runs["root"] / "two_classes.json"
    two.write_text(json.dumps(gt))
    src = os.path.join(runs["full"], "ckpt.npz")
    out = runs["root"] / "transfer"
    argv = ["--model", "yolov10n", "--weights", src, "--train-images", img_dir, "--train-ann", str(two),
            "--val-images", img_dir, "--val-ann", str(two), "--imgsz", "64", "--batch-size", "4", "--max-boxes",
            "8", "--workers", "2", "--device", "cpu", "--epochs", "2", "--unfreeze-epoch", "1", "--no-amp",
            "--out-dir", str(out)]
    with pytest.warns(RuntimeWarning, match="Transfer load"):
        transfer_learn.main(argv)
    log = (out / "train.log").read_text()
    line = next(l for l in log.splitlines() if "transfer init from" in l)
    loaded, total = (int(v) for v in line.split(": ")[1].split(" leaves")[0].split("/"))
    skipped = int(line.split("loaded, ")[1].split(" ")[0])
    assert skipped > 0 and loaded + skipped == total  # the class-dependent head leaves
    for text in ("RUN START", "head reset to fresh random init", "EPOCH 1/2 loss=", "VAL epoch 1 mAP50-95=",
                 "UNFREEZE backbone at epoch 2", "EPOCH 2/2 loss=", "VAL epoch 2 mAP50-95=", "RUN END best"):
        assert text in log, text
    assert log.index("VAL epoch 1") < log.index("UNFREEZE") < log.index("EPOCH 2/2")
    assert (out / "best.npz").exists()
    assert "map_50_95" in jload_checkpoint_meta(str(out / "best.npz"))
    # Epoch 1 frozen: backbone and neck weights as loaded; epoch 2 trains them.
    with np.load(src) as s, np.load(out / "epoch001.npz") as e1, np.load(out / "epoch002.npz") as e2:
        frozen = [k for k in s.files if k.split(".")[0] in ("backbone", "neck") and k.endswith("conv.weight")]
        assert frozen
        assert all(np.array_equal(s[k], e1[k]) for k in frozen)
        assert any(not np.array_equal(e1[k], e2[k]) for k in frozen)


def test_clis_want_the_card_unless_asked_for_the_cpu(runs):
    assert train.parse_args(["--train-images", "x", "--train-ann", "y"]).device == "cuda"
    assert transfer_learn.parse_args(["--train-images", "x", "--train-ann", "y", "--val-images", "x",
                                      "--val-ann", "y"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    img_dir, ann = runs["data"]
    argv = [a for a in _common(img_dir, ann) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run_train(argv + ["--epochs", "1", "--out-dir", str(runs["root"] / "no_card")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transfer_learn.main(argv + ["--weights", "none", "--epochs", "1", "--out-dir", str(runs["root"] / "no_card2")])
