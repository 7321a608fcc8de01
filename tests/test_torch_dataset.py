"""The port's COCO dataset and loader (`leanyolo_tpu_torch/data/dataset.py`)
against the JAX package's on the same files.

Items and batches must be bit-equal: letterboxed images (the port decodes
with PIL and letterboxes without cv2, JAX with cv2), the padded GT arrays
and every meta entry (gain, pad, orig_hw, image_id), with a padded last
batch whose metas are None. Errors and early stops behave as JAX's loader's.
"""

from __future__ import annotations

import json
import os
import threading
import time

import cv2
import numpy as np
import pytest

from leanyolo_tpu.data.coco import coco80_class_names as jcoco80_class_names
from leanyolo_tpu.data.dataset import CocoDetection as JCocoDetection, DataLoader as JDataLoader
from leanyolo_tpu_torch.data.coco import coco80_class_names
from leanyolo_tpu_torch.data.dataset import CocoDetection, DataLoader
from synth_coco import make_learnable_coco, make_synth_coco


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """make_synth_coco's 5 images with category ids out of order, a crowd
    annotation and an annotation of an image left out by max_images."""
    img_dir, ann_path = make_synth_coco(str(tmp_path_factory.mktemp("coco")), n_images=5)
    with open(ann_path) as f:
        ann = json.load(f)
    remap = {1: 7, 2: 3, 3: 12}
    ann["categories"] = [{"id": remap[c["id"]], "name": c["name"]} for c in ann["categories"]][::-1]
    for a in ann["annotations"]:
        a["category_id"] = remap[a["category_id"]]
    ann["annotations"].append({"id": 99, "image_id": 2, "category_id": 3, "bbox": [1.0, 2.0, 30.0, 20.0],
                               "area": 600.0, "iscrowd": 1})
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return img_dir, ann_path


def _assert_target_equal(t, j):
    assert set(t) == set(j)
    for k in ("boxes", "labels"):
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])
    for k in ("image_id", "orig_hw", "gain", "pad"):
        assert t[k] == j[k], k


@pytest.mark.parametrize("max_images", [None, 4])
def test_items_equal_jax(synth, max_images):
    img_dir, ann = synth
    ds = CocoDetection(img_dir, ann, img_size=64, max_images=max_images)
    jds = JCocoDetection(img_dir, ann, img_size=64, max_images=max_images)
    assert len(ds) == len(jds) == (max_images or 5)
    assert ds.cat_ids == jds.cat_ids == [3, 7, 12]
    assert ds.cat_id_to_idx == jds.cat_id_to_idx and ds.class_names == jds.class_names
    assert ds.images == jds.images and ds.anns_by_image == jds.anns_by_image
    assert all(a["iscrowd"] == 0 for anns in ds.anns_by_image.values() for a in anns)
    for i in range(len(ds)):
        img, t = ds[i]
        jimg, jt = jds[i]
        assert img.dtype == jimg.dtype == np.uint8 and img.shape == jimg.shape == (64, 64, 3)
        np.testing.assert_array_equal(img, jimg)
        _assert_target_equal(t, jt)


def test_pil_decodes_as_cv2(tmp_path):
    """load_image (PIL) against cv2.imread + BGR2RGB on the JPEGs both
    synthetic sets write."""
    for make, kw in ((make_synth_coco, {}), (make_learnable_coco, {"n_images": 20})):
        img_dir, ann = make(str(tmp_path / make.__name__), **kw)
        ds = CocoDetection(img_dir, ann)
        for i in range(len(ds)):
            want = cv2.cvtColor(cv2.imread(os.path.join(img_dir, ds.images[i]["file_name"])), cv2.COLOR_BGR2RGB)
            np.testing.assert_array_equal(ds.load_image(i), want)


@pytest.mark.parametrize("batch_size,max_boxes", [(2, 1), (4, 3)])
def test_loader_batches_equal_jax(synth, batch_size, max_boxes):
    img_dir, ann = synth
    ds = CocoDetection(img_dir, ann, img_size=64)
    jds = JCocoDetection(img_dir, ann, img_size=64)
    loader = DataLoader(ds, batch_size=batch_size, max_boxes=max_boxes, workers=2)
    jloader = JDataLoader(jds, batch_size=batch_size, shuffle=False, max_boxes=max_boxes, workers=2)
    got, want = list(loader), list(jloader)
    assert len(got) == len(want) == len(loader) == len(jloader) == -(-5 // batch_size)
    for b, jb in zip(got, want):
        for k in ("images", "gt_labels", "gt_boxes", "gt_mask"):
            x, y = getattr(b, k), getattr(jb, k)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        assert len(b.meta) == batch_size
        for m, jm in zip(b.meta, jb.meta):
            if jm is None:
                assert m is None
            else:
                _assert_target_equal(m, jm)
    n_pad = -5 % batch_size
    assert [m is None for m in got[-1].meta] == [False] * (batch_size - n_pad) + [True] * n_pad
    np.testing.assert_array_equal(got[-1].images[-1], got[-1].images[0])  # padding repeats item 0


def test_missing_file_reaches_the_consumer(synth, tmp_path):
    img_dir, ann = synth
    with open(ann) as f:
        gt = json.load(f)
    gt["images"][3]["file_name"] = "missing.jpg"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(gt))
    loader = DataLoader(CocoDetection(img_dir, str(bad), img_size=64), batch_size=2, workers=2)
    seen = []
    with pytest.raises(FileNotFoundError):
        for batch in loader:
            seen.append(batch)
    assert len(seen) == 1  # the batch before the missing image arrived first
    with pytest.raises(FileNotFoundError):
        JCocoDetection(img_dir, str(bad), img_size=64)[3]


def test_early_break_stops_the_producer(synth):
    img_dir, ann = synth
    before = set(threading.enumerate())
    loader = DataLoader(CocoDetection(img_dir, ann, img_size=64), batch_size=1, workers=2, prefetch=1)
    it = iter(loader)
    next(it)
    time.sleep(0.3)  # the producer fills the queue and blocks on the next put
    assert set(threading.enumerate()) - before
    it.close()  # what a `break` out of a for loop does to the generator
    deadline = time.monotonic() + 10
    while set(threading.enumerate()) - before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def test_coco80_class_names_equal_jax():
    assert coco80_class_names() == jcoco80_class_names()
    assert len(coco80_class_names()) == 80
