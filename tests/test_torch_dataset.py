"""The port's COCO dataset and loader (`leanyolo_tpu_torch/data/dataset.py`)
against the JAX package's on the same files.

Items and batches must be bit-equal: letterboxed images (the port decodes
with PIL and letterboxes without cv2, JAX with cv2), the padded GT arrays
and every meta entry (gain, pad, orig_hw, image_id), with a padded last
batch whose metas are None. Errors and early stops behave as JAX's loader's.

The training half is held the same way: shuffled epochs, `set_epoch`
replay, a padded and a full last batch, in host mode and in device mode (the canvas, its
geometry arrays and the boxes in original pixels). The decode equals
`cv2.imread` + BGR -> RGB (largest gap 0) on every kind of file tried,
16-bit grayscale PNGs and CMYK JPEGs among them.
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
from leanyolo_tpu_torch.data.dataset import CocoDetection, DataLoader, DeviceBatch
from synth_coco import make_learnable_coco, make_synth_coco
from torch_parity import make_mixed_coco


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
    for k in ("image_id", "orig_hw", "gain", "pad", "new_hw"):
        assert t.get(k) == j.get(k), k


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


def _write_image(kind: str, path: str, rng: np.random.RandomState) -> None:
    from PIL import Image

    h, w = 37, 53
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    gray = rng.randint(0, 256, (h, w)).astype(np.uint8)
    if kind == "gray16.png":
        Image.fromarray(rng.randint(0, 65536, (h, w)).astype(np.uint16)).save(path)
    elif kind == "cmyk.jpg":
        Image.fromarray(rng.randint(0, 256, (h, w, 4)).astype(np.uint8), mode="CMYK").save(path, quality=95)
    elif kind == "rgb.jpg":
        cv2.imwrite(path, rgb)
    elif kind == "gray.jpg":
        Image.fromarray(gray).save(path)
    elif kind == "exif_rotated.jpg":
        exif = Image.Exif()
        exif[0x0112] = 6  # orientation: rotate 90 degrees clockwise to view
        Image.fromarray(rgb).save(path, exif=exif)
    elif kind == "rgba.png":
        Image.fromarray(rng.randint(0, 256, (h, w, 4)).astype(np.uint8), mode="RGBA").save(path)
    elif kind == "la.png":
        Image.fromarray(rng.randint(0, 256, (h, w, 2)).astype(np.uint8), mode="LA").save(path)
    elif kind == "palette.png":
        Image.fromarray(rgb).quantize(16).save(path)
    elif kind == "1bit.png":
        Image.fromarray(gray > 127).save(path)
    elif kind == "rgb16.png":
        cv2.imwrite(path, rng.randint(0, 65536, (h, w, 3)).astype(np.uint16))
    elif kind == "rgb.bmp":
        cv2.imwrite(path, rgb)
    elif kind == "lossless.webp":
        Image.fromarray(rgb).save(path, lossless=True)
    elif kind == "gray.tif":
        Image.fromarray(gray).save(path)
    else:
        raise ValueError(kind)


DECODE_KINDS = ("gray16.png", "cmyk.jpg", "rgb.jpg", "gray.jpg", "exif_rotated.jpg", "rgba.png", "la.png",
                "palette.png", "1bit.png", "rgb16.png", "rgb.bmp", "lossless.webp", "gray.tif")


@pytest.mark.parametrize("kind", DECODE_KINDS)
def test_decode_equals_cv2_on_every_kind_of_file(tmp_path, kind):
    """load_image against cv2.imread(IMREAD_COLOR) + BGR2RGB, largest gap 0.
    PIL's own conversions differ on the first two kinds: a 16-bit grayscale
    PNG clips at 255 where cv2 keeps the high byte, and a CMYK JPEG is off
    by one level where OpenCV rounds its CMYK -> BGR with a shift."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    _write_image(kind, str(img_dir / kind), np.random.RandomState(DECODE_KINDS.index(kind)))
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": [{"id": 1, "file_name": kind}], "annotations": [], "categories": []}))
    got = CocoDetection(str(img_dir), str(ann)).load_image(0)
    want = cv2.cvtColor(cv2.imread(str(img_dir / kind), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int(np.abs(got.astype(np.int32) - want).max()) == 0


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    return make_mixed_coco(str(tmp_path_factory.mktemp("mixed")), n_images=10)


def _assert_batches_equal(got, want, fields):
    assert len(got) == len(want)
    for b, jb in zip(got, want):
        for k in fields:
            x, y = getattr(b, k), getattr(jb, k)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        assert len(b.meta) == len(jb.meta)
        for m, jm in zip(b.meta, jb.meta):
            if jm is None:
                assert m is None
            else:
                _assert_target_equal(m, jm)


@pytest.mark.parametrize("preprocess", ["host", "device"])
@pytest.mark.parametrize("batch_size", [4, 5])
def test_training_loader_batches_equal_jax(mixed, preprocess, batch_size):
    """Shuffled epochs 0 and 1 (the epoch advances per iteration), then
    `set_epoch(1)` replays epoch 1: every batch bit-equal to JAX's loader's
    for the same seed (10 images; batch 4 pads the last batch, batch 5
    fills it)."""
    img_dir, ann = mixed
    ds = CocoDetection(img_dir, ann, img_size=64, preprocess=preprocess)
    jds = JCocoDetection(img_dir, ann, img_size=64, preprocess=preprocess)
    assert ds.canvas_size == jds.canvas_size
    kw = dict(batch_size=batch_size, shuffle=True, max_boxes=3, workers=2, seed=3)
    loader, jloader = DataLoader(ds, **kw), JDataLoader(jds, **kw)
    assert len(loader) == len(jloader) == -(-10 // batch_size)
    fields = ("images",) if preprocess == "host" else ("canvas", "new_hw", "pads", "hw", "gainpad")
    fields += ("gt_labels", "gt_boxes", "gt_mask")
    epochs = [list(loader), list(loader)]
    for got, want in zip(epochs, [list(jloader), list(jloader)]):
        _assert_batches_equal(got, want, fields)
        assert isinstance(got[0], DeviceBatch) == (preprocess == "device")
        assert all(b.meta[-1] is not None for b in got) == (batch_size == 5)
    order = lambda batches: [m["image_id"] for b in batches for m in b.meta if m is not None]
    assert order(epochs[0]) != order(epochs[1])  # a new order each epoch
    loader.set_epoch(1)
    _assert_batches_equal(list(loader), epochs[1], fields)
    if batch_size == 4:
        last = epochs[0][-1]
        assert [m is None for m in last.meta] == [False, False, True, True]
        first = last.images if preprocess == "host" else last.canvas
        np.testing.assert_array_equal(first[2], first[0])  # padding repeats item 0 ...
        if preprocess == "device":  # ... with its geometry and an empty target
            np.testing.assert_array_equal(last.gainpad[2], last.gainpad[0])
            np.testing.assert_array_equal(last.new_hw[3], last.new_hw[0])
        assert not last.gt_mask[2:].any()


def test_device_items_keep_original_coordinates(mixed):
    """A device item is the raw image with its boxes in original pixels;
    mapped by gain and pad they are the host item's boxes."""
    img_dir, ann = mixed
    host = CocoDetection(img_dir, ann, img_size=64)
    dev = CocoDetection(img_dir, ann, img_size=64, preprocess="device")
    for i in range(len(dev)):
        img, t = dev[i]
        np.testing.assert_array_equal(img, dev.load_image(i))
        _, ht = host[i]
        (gw, gh), (px, py) = t["gain"], t["pad"]
        assert (gw, gh) == ht["gain"] and (px, py) == ht["pad"]
        mapped = t["boxes"].astype(np.float64) * [gw, gh, gw, gh] + [px, py, px, py]
        np.testing.assert_allclose(mapped, ht["boxes"], rtol=0, atol=1e-4)
        assert t["new_hw"] == (round(img.shape[0] * gh), round(img.shape[1] * gw))


def test_device_mode_needs_image_sizes(mixed, tmp_path):
    """The canvas is sized at construction from the annotations: an entry
    without height and width raises, as JAX's `dataset_canvas_size` does."""
    img_dir, ann = mixed
    with open(ann) as f:
        gt = json.load(f)
    del gt["images"][4]["height"]
    bad = tmp_path / "no_sizes.json"
    bad.write_text(json.dumps(gt))
    for cls in (CocoDetection, JCocoDetection):
        with pytest.raises(ValueError, match="height/width"):
            cls(img_dir, str(bad), img_size=64, preprocess="device")
        cls(img_dir, str(bad), img_size=64)  # host mode does not need them
    with pytest.raises(ValueError, match="preprocess"):
        CocoDetection(img_dir, ann, preprocess="gpu")


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
