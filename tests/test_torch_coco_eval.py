"""The port's numpy COCO evaluator (`leanyolo_tpu_torch/utils/coco_eval.py`)
against the JAX package's on the same inputs.

Scenes come from the JAX package's differential test generator: crowds,
areas at exactly 32^2 and 96^2, score ties, duplicate detections, more
than maxDets detections per image and category, empty images, categories
with no ground truth. The stats dicts must be equal (`==`, not close), for
dict and columnar feeds, scored in one shot or image by image.
"""

from __future__ import annotations

import numpy as np
import pytest

from leanyolo_tpu.utils import coco_eval as jcoco_eval
from leanyolo_tpu.utils.coco_eval import CocoEvaluator as JCocoEvaluator
from leanyolo_tpu_torch.utils import coco_eval
from leanyolo_tpu_torch.utils.coco_eval import CocoEvaluator
from test_coco_eval_differential import _random_scene


def _columns(results):
    n = len(results)
    return (
        np.asarray([r["image_id"] for r in results], np.int64),
        np.asarray([r["category_id"] for r in results], np.int64),
        np.asarray([r["bbox"] for r in results], np.float64).reshape(n, 4),
        np.asarray([r["score"] for r in results], np.float64),
    )


def _jax_stats(gt, results):
    ev = JCocoEvaluator(gt)
    ev.add_detections(results)
    return ev.evaluate()


def _port_stats(gt, results, feed):
    ev = CocoEvaluator(gt)
    if feed == "dicts":
        ev.add_detections(results)
    elif feed == "arrays":
        ev.add_detections_arrays(*_columns(results))
    else:  # incremental: two images at a time, each scored once its detections are in
        ids = sorted(im["id"] for im in gt["images"])
        for k in range(0, len(ids), 2):
            part = [r for r in results if r["image_id"] in ids[k:k + 2]]
            if part:
                ev.add_detections_arrays(*_columns(part))
            ev.score_images(ids[k:k + 2])
    return ev.evaluate()


def _scene(seed):
    hard = seed >= 20
    return _random_scene(np.random.RandomState(seed), n_imgs=3 if hard else 4, n_cats=2 if hard else 3, hard=hard)


@pytest.mark.parametrize("feed", ["dicts", "arrays", "incremental"])
@pytest.mark.parametrize("seed", range(32))
def test_evaluator_equals_jax(seed, feed):
    gt, results = _scene(seed)
    want = _jax_stats(gt, results)
    got = _port_stats(gt, results, feed)
    assert got == want


def test_late_add_rescores_as_jax():
    """Detections added for an image after it was scored: both evaluators
    drop their incremental state and score everything again."""
    gt, results = _scene(21)
    img0 = gt["images"][0]["id"]
    first = [r for r in results if r["image_id"] == img0]
    assert len(first) >= 2
    evs = [CocoEvaluator(gt), JCocoEvaluator(gt)]
    for ev in evs:
        ev.add_detections(first[: len(first) // 2])
        ev.score_images([img0])
        ev.add_detections(first[len(first) // 2:] + [r for r in results if r["image_id"] != img0])
    got, want = (ev.evaluate() for ev in evs)
    assert got == want == _jax_stats(gt, results)


@pytest.mark.parametrize("case", ["crowd", "ignore-order", "area-ignore", "no-dets", "det-without-gt"])
def test_fixed_scenes_equal_jax(case):
    """The differential test's hand-made scenes."""
    box = {"image_id": 1, "category_id": 1, "iscrowd": 0}
    if case == "crowd":
        anns = [dict(box, bbox=[0, 0, 100, 100], iscrowd=1, area=1e4), dict(box, bbox=[200, 200, 50, 50], area=2500.0)]
        dets = [([0, 0, 50, 100], 0.9), ([50, 0, 50, 100], 0.8), ([200, 200, 50, 50], 0.7)]
    elif case == "ignore-order":
        anns = [dict(box, bbox=[0, 0, 20, 20], area=400.0), dict(box, bbox=[100, 100, 200, 200], area=4e4)]
        dets = [([2, 2, 20, 20], 0.9), ([98, 98, 200, 200], 0.5), ([0, 0, 19, 21], 0.4)]
    elif case == "area-ignore":
        anns = [dict(box, bbox=[50, 50, 40, 40], area=1600.0)]
        dets = [([50, 50, 40, 40], 0.9), ([300, 300, 200, 200], 0.8)]
    else:
        anns = [dict(box, bbox=[0, 0, 50, 50], area=2500.0)]
        dets = [] if case == "no-dets" else [([0, 0, 10, 10], 0.5)]
    gt = {"images": [{"id": 1}, {"id": 2}], "categories": [{"id": 1}, {"id": 2}], "annotations": anns}
    results = [{"image_id": 1 if case != "det-without-gt" else 2, "category_id": 1 if case != "det-without-gt" else 2,
                "bbox": b, "score": s} for b, s in dets]
    for feed in ("dicts", "arrays", "incremental"):
        assert _port_stats(gt, results, feed) == _jax_stats(gt, results), feed


def test_constants_equal_jax():
    for name in ("IOU_THRS", "REC_THRS", "_AREA_LO", "_AREA_HI", "_THR_EFF"):
        np.testing.assert_array_equal(getattr(coco_eval, name), getattr(jcoco_eval, name))
    assert coco_eval.AREA_RNGS == jcoco_eval.AREA_RNGS and coco_eval._AREA_ORDER == jcoco_eval._AREA_ORDER
