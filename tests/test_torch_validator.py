"""The port's COCO validation (`leanyolo_tpu_torch/engine/validator.py`)
against the JAX package's `validate_coco`, on the CPU, in fp32.

Two models, each with the same weights in both packages:

- *parity*: yolov10n (3 classes) from the seed with randomized BN
  statistics (`torch_parity.randomize_bn`), on `make_synth_coco`'s five
  images at 64 px, batch 2 (a padded last batch). The saved detections
  must agree: image ids and counts per image exact; at every rank whose
  score is more than 1e-4 from its neighbours' the category exact and the
  score and the box (xywh, original pixels) within 5e-4; ranks whose score
  lies within 1e-4 of a neighbour's may come in either order under fp32
  noise and are matched as a set per image, with the same tolerances. The
  random weights put every score near 0.5, so the mAP says nothing here
  and is not compared.
- *self-labelled*: yolov10n (3 classes) at 96 px with BN statistics
  calibrated on the letterboxed images of a six-image `make_synth_coco` set
  and the class logits rescaled there to mean -4, std 1, so that scores
  spread over (0, 1). The set is labelled by JAX's own detections with each
  decode (see `self_labels`), batch 4 (a padded last batch). Both
  packages' six stats agree within 1e-4, with map_50_95 above 0.5. The
  saved detections are compared as above but for the boxes, which agree
  within 5e-4 of the image's longer side (0.064 px): in this calibrated
  net the head maps of the two packages differ well within the repo's fp32
  rule (5e-4 of their scale), but by enough that the DFL decode moves some
  boxes by more than 5e-4 px.

Both comparisons run for both decodes and both preprocess modes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from leanyolo_tpu.engine.validator import detections_to_coco_arrays as jdetections_to_coco_arrays
from leanyolo_tpu.engine.validator import validate_coco as jvalidate_coco
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10
from leanyolo_tpu_torch import Predictor, YOLOv10
from leanyolo_tpu_torch.data.dataset import CocoDetection
from leanyolo_tpu_torch.engine.validator import detections_to_coco_arrays, measure_fps, validate_coco
from leanyolo_tpu_torch.models.yolov10.convert import export_jax_params, load_jax_params
from synth_coco import make_synth_coco
from torch_parity import calibrated_model, randomize_bn, self_labels

NC = 3
KEYS = ("map_50_95", "map_50", "map_75", "map_small", "map_medium", "map_large")
MODES = [(d, p) for d in ("topk", "nms") for p in ("host", "device")]


def _jax_twin(tm: YOLOv10) -> JYOLOv10:
    cfg = JYOLOv10.create("yolov10n", class_names=tm.class_names).cfg
    return JYOLOv10(cfg=cfg, class_names=tm.class_names, params=export_jax_params(tm))


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """(port model, JAX model, validate_coco kwargs) of the parity comparison."""
    jm = JYOLOv10.create("yolov10n", class_names=[f"class{c}" for c in range(NC)], seed=5)
    jm = JYOLOv10(cfg=jm.cfg, class_names=jm.class_names, params=randomize_bn(jm.params, np.random.RandomState(5)))
    tm = load_jax_params(YOLOv10.create("yolov10n", class_names=jm.class_names), jm.params)
    img_dir, ann = make_synth_coco(str(tmp_path_factory.mktemp("parity")), n_images=5)
    return tm, jm, dict(images_dir=img_dir, ann_json=ann, imgsz=64, batch_size=2, workers=2)


@pytest.fixture(scope="module")
def selflabelled(tmp_path_factory):
    """(port model, JAX model, a second port model, validate_coco kwargs,
    {decode: annotation file labelled by JAX})."""
    root = str(tmp_path_factory.mktemp("selflabel"))
    img_dir, ann = make_synth_coco(root, n_images=6)
    with open(ann) as f:
        blank = dict(json.load(f), annotations=[])
    image_ids = [im["id"] for im in blank["images"]]
    kw = dict(images_dir=img_dir, imgsz=96, batch_size=4, workers=2)
    blank_path = os.path.join(root, "blank.json")
    with open(blank_path, "w") as f:
        json.dump(blank, f)
    ds = CocoDetection(img_dir, blank_path, img_size=kw["imgsz"])
    letterboxed = np.stack([ds[i][0] for i in range(len(ds))])
    tm, other = calibrated_model(3, letterboxed), calibrated_model(4, letterboxed)
    jm = _jax_twin(tm)
    anns = {}
    for decode in ("topk", "nms"):
        dets = os.path.join(root, f"labels_{decode}.json")
        jvalidate_coco(jm, ann_json=blank_path, decode=decode, save_detections=dets, **kw)
        with open(dets) as f:
            labels = self_labels(json.load(f), image_ids)
        anns[decode] = os.path.join(root, f"ann_{decode}.json")
        with open(anns[decode], "w") as f:
            json.dump(dict(blank, annotations=labels), f)
    return tm, jm, other, kw, anns


def _run_both(tm, jm, tmp_path, **kw):
    """Both packages' validate_coco on the same arguments -> (port stats,
    JAX stats, port results by image, JAX results by image)."""
    paths = [str(tmp_path / "t.json"), str(tmp_path / "j.json")]
    got = validate_coco(tm, save_detections=paths[0], device="cpu", **kw)
    want = jvalidate_coco(jm, save_detections=paths[1], **kw)
    by_image = []
    for p in paths:
        with open(p) as f:
            out = {}
            for r in json.load(f):
                out.setdefault(r["image_id"], []).append(r)
            by_image.append(out)
    return got, want, by_image[0], by_image[1]


def _assert_same_detections(tr: list, jr: list, box_tol: float) -> None:
    """One image's saved detections, the port's against JAX's: the same
    count; at every rank whose JAX score is more than 1e-4 from its
    neighbours' the same category, the score within 5e-4 and the box within
    box_tol; the other ranks matched as a set (each port row to a distinct
    JAX row among them with the same category and the same tolerances)."""
    assert len(tr) == len(jr)
    s = np.asarray([r["score"] for r in jr])
    gap = np.minimum(np.abs(np.diff(s, prepend=np.inf)), np.abs(np.diff(s, append=-np.inf)))
    apart = gap > 1e-4
    cat, jcat = (np.asarray([r["category_id"] for r in res]) for res in (tr, jr))
    box, jbox = (np.asarray([r["bbox"] for r in res]).reshape(-1, 4) for res in (tr, jr))
    score, jscore = np.asarray([r["score"] for r in tr]), s
    np.testing.assert_array_equal(cat[apart], jcat[apart])
    np.testing.assert_allclose(score[apart], jscore[apart], rtol=0, atol=5e-4)
    np.testing.assert_allclose(box[apart], jbox[apart], rtol=0, atol=box_tol)
    pool = list(np.flatnonzero(~apart))
    for i in np.flatnonzero(~apart):
        hit = next((k for k, j in enumerate(pool) if jcat[j] == cat[i] and abs(jscore[j] - score[i]) <= 5e-4
                    and np.all(np.abs(jbox[j] - box[i]) <= box_tol)), None)
        assert hit is not None, (cat[i], score[i], box[i])
        pool.pop(hit)


@pytest.mark.parametrize("decode,preprocess", MODES)
def test_validate_coco_detections_match_jax(parity, tmp_path, decode, preprocess):
    tm, jm, kw = parity
    got, want, tres, jres = _run_both(tm, jm, tmp_path, decode=decode, preprocess=preprocess, **kw)
    assert got["n_images"] == want["n_images"] == 5
    assert list(tres) == list(jres) == [1, 2, 3, 4, 5]
    for img, jr in jres.items():
        _assert_same_detections(tres[img], jr, box_tol=5e-4)


@pytest.mark.parametrize("decode,preprocess", MODES)
def test_self_labelled_map_matches_jax(selflabelled, tmp_path, decode, preprocess):
    tm, jm, _, kw, anns = selflabelled
    got, want, tres, jres = _run_both(tm, jm, tmp_path, decode=decode, preprocess=preprocess, ann_json=anns[decode],
                                      **kw)
    assert got["n_images"] == want["n_images"] == 6
    assert got["map_50_95"] > 0.5 and want["map_50_95"] > 0.5, (got, want)
    for k in KEYS:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    assert list(tres) == list(jres) and len(jres) == 6
    for img, jr in jres.items():
        _assert_same_detections(tres[img], jr, box_tol=5e-4 * 128)


def test_detections_to_coco_arrays_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    b, a = 4, 30
    dets = rng.uniform(-20, 120, (b, a, 6)).astype(np.float32)
    dets[..., 4] = np.sort(rng.uniform(0, 1, (b, a)).astype(np.float32), axis=1)[:, ::-1]
    dets[..., 5] = rng.randint(0, NC, (b, a))
    num = np.asarray([0, 7, 30, 12], np.int32)
    metas = [{"image_id": 5, "gain": (0.75, 0.75), "pad": (0, 12), "orig_hw": (96, 128)},
             None,
             {"image_id": 2, "gain": (0.5, 0.5), "pad": (8, 0), "orig_hw": (150, 100)},
             {"image_id": 9, "gain": (1.0, 1.0), "pad": (3, 5), "orig_hw": (90, 90)}]
    cat_ids = (2, 4, 9)
    for decode in ("topk", "nms"):
        got = detections_to_coco_arrays(dets, num, metas, cat_ids, decode=decode)
        want = jdetections_to_coco_arrays(dets, num, metas, cat_ids, decode=decode)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    empty = detections_to_coco_arrays(dets, num, [None] * b, cat_ids, decode="nms")
    assert [len(c) for c in empty] == [0, 0, 0, 0]


def test_predictor_reuse_equals_fresh_predictors(selflabelled):
    """One predictor for two models in turn (update_params at each call)
    gives the stats of a fresh predictor for each, and leaves both models
    as they were."""
    tm, _, other, kw, anns = selflabelled
    kw = dict(kw, ann_json=anns["topk"], decode="topk")
    states = [{k: v.clone() for k, v in m.state_dict().items()} for m in (other, tm)]
    fresh = [validate_coco(m, device="cpu", **kw) for m in (other, tm)]
    pred = Predictor(tm, imgsz=kw["imgsz"], decode="topk", conf_thresh=0.001, iou_thresh=0.65, device="cpu")
    reused = [validate_coco(m, predictor=pred, **kw) for m in (other, tm)]
    for f, r in zip(fresh, reused):
        assert {k: f[k] for k in KEYS} == {k: r[k] for k in KEYS}
    assert fresh[1]["map_50_95"] > 0.5 and fresh[0]["map_50_95"] < fresh[1]["map_50_95"]
    for m, state in zip((other, tm), states):
        assert all(torch.equal(v, state[k]) for k, v in m.state_dict().items())


def test_validate_coco_rejects_what_it_cannot_run(parity):
    tm, _, kw = parity
    with pytest.raises(ValueError, match="preprocess"):
        validate_coco(tm, preprocess="gpu", device="cpu", **kw)
    pred = Predictor(tm, imgsz=kw["imgsz"], decode="nms", device="cpu")
    with pytest.raises(ValueError, match="decode"):
        validate_coco(tm, predictor=pred, decode="topk", **kw)
    if not torch.cuda.is_available():  # no device named and no card: it raises, it does not run on the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            validate_coco(tm, **kw)


def test_measure_fps_on_the_cpu(parity):
    fps = measure_fps(Predictor(parity[0], imgsz=64, device="cpu"), batch_size=2, iters=3)
    assert np.isfinite(fps) and fps > 0
