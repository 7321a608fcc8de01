"""The port's inference CLI (leanyolo_tpu_torch/tools/infer.py) and demo
CLI (tools/update_demo_viz.py) against the JAX package, on the CPU.

The weights are a `.npz` written by JAX's `save_checkpoint`. The CLI runs
in process through its `main`; its per-box lines are held against JAX's
`Predictor.predict_images` on the same image (decoded by cv2, as the JAX
CLI decodes it) formatted with the JAX CLI's format string: per image the
same number of lines, and, matched in score order, the same class names
and ids, scores within 2e-3 and boxes within 0.2 px (the printed digits
of fp32 values that agree to 5e-4 of the image size).
"""

from __future__ import annotations

import json
import re

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from leanyolo_tpu.engine.predictor import Predictor as JPredictor
from leanyolo_tpu.models.registry import save_checkpoint as jax_save_checkpoint
from leanyolo_tpu_torch.tools import infer, update_demo_viz
from torch_parity import jax_and_port_models

LINE = re.compile(r"^(?P<file>\S+): (?P<name>.+) \((?P<cls>-?\d+)\) (?P<score>[\d.]+) "
                  r"\[(?P<x1>[-\d.]+), (?P<y1>[-\d.]+), (?P<x2>[-\d.]+), (?P<y2>[-\d.]+)\]$")
SIZES = ((80, 120), (64, 64), (100, 70))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX model, checkpoint path, source dir): three JPEGs of shapes on
    noise, one unreadable file, one file of another extension."""
    root = tmp_path_factory.mktemp("infer")
    jm, _ = jax_and_port_models("yolov10n", 3, 7)
    ckpt = str(root / "ckpt.npz")
    jax_save_checkpoint(jm, ckpt)
    src = root / "src"
    src.mkdir()
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate(SIZES):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        cv2.rectangle(img, (5, 5), (w // 2, h // 2), (30, 200, 60), -1)
        cv2.imwrite(str(src / f"im{i}.jpg"), img)
    (src / "broken.png").write_bytes(b"not an image")
    (src / "notes.txt").write_text("skipped by extension")
    return jm, ckpt, src


def _jax_lines(pred, path, names):
    bgr = cv2.imread(str(path), cv2.IMREAD_COLOR)
    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    dets = pred.predict_images([rgb], preprocess="host")[0]
    out = []
    for d in dets:
        x1, y1, x2, y2, score, cls = d[:6]
        name = names[int(cls)] if int(cls) < len(names) else str(int(cls))
        out.append(f"{path.name}: {name} ({int(cls)}) {score:.3f} [{x1:.1f}, {y1:.1f}, {x2:.1f}, {y2:.1f}]")
    return out


def _parse(lines):
    out = {}
    for line in lines:
        m = LINE.match(line)
        if m:
            out.setdefault(m["file"], []).append(m)
    return out


@pytest.mark.parametrize("decode,names_flag", [("topk", "ann"), ("nms", "list")])
def test_infer_cli_matches_jax(setup, tmp_path, capsys, decode, names_flag):
    jm, ckpt, src = setup
    names = ["rect", "circle", "tri"]
    if names_flag == "ann":
        ann = tmp_path / "ann.json"
        ann.write_text(json.dumps({"categories": [{"id": 3, "name": "tri"}, {"id": 1, "name": "rect"},
                                                  {"id": 2, "name": "circle"}]}))
        flag = ["--classes-ann", str(ann)]
    else:
        flag = ["--class-names", ",".join(names)]
    save = tmp_path / "out"
    infer.main(["--source", str(src), "--model", "yolov10n", "--weights", ckpt, "--imgsz", "64", "--decode", decode,
                "--conf", "0.3", "--save-dir", str(save), "--device", "cpu", *flag])
    lines = capsys.readouterr().out.splitlines()
    assert f"skip unreadable image: {src / 'broken.png'}" in lines
    pred = JPredictor(jm, imgsz=64, decode=decode, conf_thresh=0.3, donate=False)
    ref = []
    for i in range(len(SIZES)):
        ref += _jax_lines(pred, src / f"im{i}.jpg", names)
    got, want = _parse(lines), _parse(ref)
    assert sorted(got) == sorted(want) == [f"im{i}.jpg" for i in range(len(SIZES))]
    assert sum(len(v) for v in want.values()) >= 3
    for f in want:
        assert len(got[f]) == len(want[f])
        for g, w in zip(sorted(got[f], key=lambda m: -float(m["score"])), sorted(want[f], key=lambda m: -float(m["score"]))):
            assert (g["name"], g["cls"]) == (w["name"], w["cls"])
            assert abs(float(g["score"]) - float(w["score"])) <= 2e-3
            for k in ("x1", "y1", "x2", "y2"):
                assert abs(float(g[k]) - float(w[k])) <= 0.2
        assert f"saved: {save / f} ({len(want[f])} detections)" in lines
        drawn = cv2.imread(str(save / f))
        assert drawn is not None and drawn.shape == cv2.imread(str(src / f)).shape
    assert sorted(p.name for p in save.iterdir()) == [f"im{i}.jpg" for i in range(len(SIZES))]


def test_list_images_and_class_names(setup, tmp_path):
    _, _, src = setup
    assert [p.name for p in infer.list_images(str(src))] == ["broken.png", "im0.jpg", "im1.jpg", "im2.jpg"]
    assert [p.name for p in infer.list_images(str(src / "im1.jpg"))] == ["im1.jpg"]
    with pytest.raises(FileNotFoundError):
        infer.list_images(str(tmp_path / "missing"))
    args = infer.parse_args(["--source", "x"])
    assert args.device == "cuda" and args.preprocess == "host" and len(infer.class_names_of(args)) == 80


def test_update_demo_viz_scene_and_output(tmp_path, capsys):
    """The synthetic scene is JAX's (its six cv2-filled rectangles from
    RandomState(0), BGR, turned to RGB), and the CLI writes the drawn image."""
    rng = np.random.RandomState(0)
    bgr = np.full((480, 640, 3), 180, np.uint8)
    for _ in range(6):
        x, y = rng.randint(0, 500), rng.randint(0, 340)
        cv2.rectangle(bgr, (x, y), (x + rng.randint(40, 140), y + rng.randint(40, 140)),
                      tuple(int(c) for c in rng.randint(0, 255, 3)), -1)
    np.testing.assert_array_equal(update_demo_viz.synthetic_scene(), cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    out = tmp_path / "demo.jpg"
    update_demo_viz.main(["--model", "yolov10n", "--weights", "none", "--imgsz", "64", "--conf", "0.0",
                          "--out", str(out), "--device", "cpu"])
    assert re.match(rf"wrote {re.escape(str(out))} \(\d+ detections\)", capsys.readouterr().out.strip().splitlines()[-1])
    assert cv2.imread(str(out)).shape == (480, 640, 3)
