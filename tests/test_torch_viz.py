"""Drawing (leanyolo_tpu_torch/utils/viz.py) and its callers -- the
validator's viz_dir, the val CLI's --viz-* flags and the transfer CLI's
snapshots -- against the JAX package (which draws with cv2), on the CPU.

The port draws on RGB images, JAX on BGR ones; the default green is green
in both orders, so the port's pixels are compared with JAX's channels
reversed. The box outlines and the filled label backgrounds are cv2's
pixels exactly. The label text is drawn with PIL where JAX uses
cv2.putText: the one region where pixels may differ, and the tests mask
exactly that region, each label's background rectangle (the text lies
inside it in both).
"""

from __future__ import annotations

import json
import os
import random

import cv2
import numpy as np
import pytest

from leanyolo_tpu.data.dataset import CocoDetection as JCocoDetection
from leanyolo_tpu.engine import validator as JV
from leanyolo_tpu.utils.viz import draw_detections as jax_draw
from leanyolo_tpu_torch.data.dataset import CocoDetection
from leanyolo_tpu_torch.engine import validator as TV
from leanyolo_tpu_torch.utils import viz
from synth_coco import make_synth_coco
from torch_parity import jax_and_port_models

NAMES = ["person", "bicycle", "car", "dog"]


def label_mask(shape, dets, class_names) -> np.ndarray:
    """The label background rectangles of `dets` (clipped): where the text is."""
    mask = np.zeros(shape[:2], bool)
    for d in np.asarray(dets):
        x1, y1 = int(round(d[0])), int(round(d[1]))
        (tw, th), base = viz.text_size(viz.label_text(int(d[5]), d[4], class_names))
        ty = max(y1 - 4, th + 2)
        mask[max(ty - th - 2, 0):max(ty + base - 1, 0), max(x1, 0):max(x1 + tw + 3, 0)] = True
    return mask


def assert_drawn_alike(got_rgb: np.ndarray, jax_bgr: np.ndarray, dets, class_names) -> None:
    """Equal outside the labels' text region; some text pixels inside it."""
    diff = (got_rgb != jax_bgr[..., ::-1]).any(-1)
    mask = label_mask(got_rgb.shape, dets, class_names)
    assert not (diff & ~mask).any(), np.argwhere(diff & ~mask)[:10]
    if len(dets):
        assert (got_rgb[mask][:, 1] < 128).any()  # dark text was drawn on the green


def _dets(seed: int, n: int, h: int, w: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-10, [w, h], (n, 2))
    wh = rng.uniform(0, [w / 2, h / 2], (n, 2))
    d = np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 1)), rng.randint(0, 6, (n, 1))], 1).astype(np.float32)
    d[0, :4] = [0, 0, w, h]  # the whole image: outline on the border
    d[1, :4] = [w - 3.5, h - 2.5, w + 4, h + 9]  # past the corner
    d[2, :4] = [20.5, 30.5, 20.5, 30.5]  # a point; x.5 rounds to even as Python's round
    return d


@pytest.mark.parametrize("names", [NAMES, None, []])
def test_draw_detections_matches_jax(names):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (120, 160, 3), np.uint8)
    dets = _dets(1, 12, 120, 160)
    got = viz.draw_detections(img, dets, names)
    ref = jax_draw(np.ascontiguousarray(img[..., ::-1]), dets, names)
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert_drawn_alike(got, ref, dets, names)
    assert np.array_equal(img, rng.__class__(0).randint(0, 256, (120, 160, 3), np.uint8))  # the input untouched
    assert np.array_equal(viz.draw_detections(img, np.zeros((0, 6), np.float32), names), img)


def test_label_text_and_class_name_fallback():
    assert viz.label_text(1, np.float32(0.876), NAMES) == "bicycle (1) 88%"
    assert viz.label_text(7, 0.5, NAMES) == "7 (7) 50%"  # past the names
    assert viz.label_text(0, 0.125, None) == "0 (0) 12%"  # round half to even, as f"{:.0f}"
    assert viz.label_text(-1, 0.995, NAMES) == "-1 (-1) 100%"
    assert viz.label_text(2, 0.3333, []) == "2 (2) 33%"


def test_text_size_equals_cv2():
    rnd = random.Random(0)
    chars = [chr(c) for c in range(32, 127)]
    labels = chars + [viz.label_text(c, s, NAMES) for c in range(6) for s in (0.01, 0.5, 0.999)]
    labels += ["".join(rnd.choice(chars) for _ in range(rnd.randint(1, 40))) for _ in range(2000)]
    for label in labels:
        assert viz.text_size(label) == cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1), label


def test_rectangles_equal_cv2():
    rnd = random.Random(1)
    for _ in range(1500):
        h, w = rnd.randint(4, 40), rnd.randint(4, 40)
        p1 = (rnd.randint(-6, w + 6), rnd.randint(-6, h + 6))
        p2 = (p1[0] + rnd.randint(0, 30), p1[1] + rnd.randint(0, 30))
        for thick, fn in ((2, viz.outline_rect), (-1, viz.fill_rect)):
            ref = np.zeros((h, w, 3), np.uint8)
            cv2.rectangle(ref, p1, p2, (0, 255, 0), thick)
            got = np.zeros((h, w, 3), np.uint8)
            fn(got, p1, p2, (0, 255, 0))
            assert np.array_equal(got, ref), (h, w, p1, p2, thick)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    img_dir, ann = make_synth_coco(str(tmp_path_factory.mktemp("viz")), n_images=5)
    return img_dir, ann


def test_viz_names_match_jax(synth):
    img_dir, ann = synth
    ds, jds = CocoDetection(img_dir, ann, img_size=64), JCocoDetection(img_dir, ann, img_size=64)
    for mode in ("file", "id", "index"):
        for i, im in enumerate(ds.images):
            m = {"image_id": im["id"]}
            assert TV._viz_name(ds, m, i + 3, mode) == JV._viz_name(jds, m, i + 3, mode)
    m = {"image_id": 999}  # not in the annotations: the index
    assert TV._viz_name(ds, m, 4, "file") == JV._viz_name(jds, m, 4, "file") == "000004.jpg"


@pytest.mark.parametrize("kind", ["batch", "original"])
@pytest.mark.parametrize("decode", ["topk", "nms"])
def test_saved_viz_images_match_jax(synth, monkeypatch, kind, decode):
    """Both letterbox modes' drawing: the letterboxed batch images (host) and
    the original images with boxes mapped back and clipped (device)."""
    img_dir, ann = synth
    ds, jds = CocoDetection(img_dir, ann, img_size=64), JCocoDetection(img_dir, ann, img_size=64)
    n = len(ds)
    rng = np.random.RandomState(2)
    if kind == "batch":
        images = np.stack([ds[i][0] for i in range(n)])
    else:
        images = [ds.load_image(i) for i in range(n)]
    metas = [{"image_id": im["id"], "gain": (0.5, 0.5), "pad": (0, 8), "orig_hw": (96, 128)} for im in ds.images]
    metas[1] = None  # padding
    dets = np.stack([_dets(10 + i, 20, 64, 64) for i in range(n)])
    dets[..., 4] = np.sort(rng.uniform(0, 1, dets.shape[:2]), axis=1)[:, ::-1]
    num = np.array([5, 3, 0, 20, 7], np.int32)
    kw = dict(decode=decode, viz_dir="unused", conf=0.4, name_mode="index", start_index=2)
    saved, jsaved = {}, {}
    monkeypatch.setattr(TV, "save_image", lambda p, a: saved.__setitem__(os.path.basename(p), a))
    monkeypatch.setattr(cv2, "imwrite", lambda p, a: jsaved.__setitem__(os.path.basename(p), a) or True)
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    if kind == "batch":
        nxt = TV._save_viz_batch(images, dets, num, metas, ds, **kw)

        class B:
            pass

        jb = B()
        jb.images, jb.meta = images, metas
        jnxt = JV._save_viz_batch(jb, dets, num, jds, **kw)
    else:
        nxt = TV._save_viz_original(images, dets, num, metas, ds, **kw)
        jnxt = JV._save_viz_original(images, dets, num, metas, jds, **kw)
    assert nxt == jnxt == 2 + n - 1 and sorted(saved) == sorted(jsaved)
    for i, name in enumerate(sorted(saved)):
        assert saved[name].shape == jsaved[name].shape
        k = [j for j, m in enumerate(metas) if m is not None][i]
        d = dets[k][: num[k]] if decode == "nms" else dets[k][dets[k][:, 4] > 0.4]
        if kind == "original":
            m = metas[k]
            d = d.copy()
            d[:, 0::2] = np.clip((d[:, 0::2] - 0) / 0.5, 0, 128)
            d[:, 1::2] = np.clip((d[:, 1::2] - 8) / 0.5, 0, 96)
        assert_drawn_alike(saved[name], jsaved[name], d, ds.class_names)


@pytest.mark.parametrize("mode,preprocess", [("file", "host"), ("id", "device"), ("index", "host")])
def test_validate_coco_writes_one_drawing_per_image(synth, tmp_path, mode, preprocess):
    _, tm = jax_and_port_models("yolov10n", 3, 5)
    img_dir, ann = synth
    out = tmp_path / "viz"
    TV.validate_coco(tm, images_dir=img_dir, ann_json=ann, imgsz=64, batch_size=2, workers=2, device="cpu",
                     decode="nms", conf_thresh=0.01, preprocess=preprocess, viz_dir=str(out), viz_conf=0.2,
                     viz_name_mode=mode)
    with open(ann) as f:
        images = sorted(json.load(f)["images"], key=lambda im: im["id"])
    want = {"file": [im["file_name"] for im in images], "id": [f"{im['id']}.jpg" for im in images],
            "index": [f"{i:06d}.jpg" for i in range(len(images))]}[mode]
    assert sorted(os.listdir(out)) == sorted(want)
    shape = (64, 64, 3) if preprocess == "host" else (96, 128, 3)
    for name in want:
        assert cv2.imread(str(out / name)).shape == shape
    with pytest.raises(ValueError, match="viz_name_mode"):
        TV.validate_coco(tm, images_dir=img_dir, ann_json=ann, imgsz=64, device="cpu", viz_name_mode="name")


def test_val_cli_viz_flags(synth, tmp_path, capsys):
    from leanyolo_tpu_torch.tools import val

    img_dir, ann = synth
    csv = tmp_path / "log.csv"
    val.main(["--device", "cpu", "--model", "yolov10n", "--weights", "none", "--images-dir", img_dir, "--ann-json",
              ann, "--imgsz", "64", "--batch-size", "2", "--workers", "2", "--log-csv", str(csv), "--viz-dir",
              str(tmp_path / "v"), "--viz-conf", "0.3", "--viz-name-mode", "index"])
    assert sorted(os.listdir(tmp_path / "v")) == [f"{i:06d}.jpg" for i in range(5)]
    import csv as csvmod

    rows = list(csvmod.DictReader(open(csv)))
    assert rows[-1]["viz_dir"] == str(tmp_path / "v")
    assert "mAP50-95=" in capsys.readouterr().out


@pytest.mark.parametrize("preprocess", ["host", "device"])
def test_transfer_cli_viz_snapshots(tmp_path, preprocess):
    """--viz-interval 2: a snapshot every second step, named by the step;
    a host batch's letterboxed image, a device batch's original image."""
    from leanyolo_tpu_torch.tools import transfer_learn

    img_dir, ann = make_synth_coco(str(tmp_path / "d"), n_images=4)
    out = tmp_path / "tl"
    transfer_learn.main(["--device", "cpu", "--model", "yolov10n", "--weights", "none", "--imgsz", "64",
                         "--batch-size", "2", "--epochs", "2", "--workers", "1", "--train-images", img_dir,
                         "--train-ann", ann, "--val-images", img_dir, "--val-ann", ann, "--eval-every", "9",
                         "--viz-interval", "2", "--viz-conf", "0.0", "--preprocess", preprocess,
                         "--out-dir", str(out)])
    assert sorted(os.listdir(out / "viz")) == ["step000002.jpg", "step000004.jpg"]
    shape = (64, 64, 3) if preprocess == "host" else (96, 128, 3)
    assert cv2.imread(str(out / "viz" / "step000004.jpg")).shape == shape
    assert "[viz] saved:" in (out / "train.log").read_text()
