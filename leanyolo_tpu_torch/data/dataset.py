"""COCO detection dataset and a prefetching fixed-shape batch loader.

Counterpart of the JAX package's `leanyolo_tpu/data/dataset.py`:

- annotations are indexed once, at construction;
- images decode with PIL to cv2.imread's pixels (`load_image`) and, in host
  mode, letterbox on the host with the port's cv2-free `letterbox` (cv2's
  pixels, bit for bit);
- in device mode an item is the raw image with its boxes in original
  coordinates and its letterbox geometry; the loader pastes a batch onto one
  fixed canvas (`DeviceBatch`) and the train step warps it on the device;
- batches are fixed-shape: images [B, S, S, 3] uint8 NHWC plus padded
  targets (labels [B, Nmax], boxes [B, Nmax, 4], mask [B, Nmax]);
- the loader shuffles with `np.random.RandomState(seed + epoch)`, as JAX's
  does, and a thread pool decodes a batch while the consumer works on the
  last one.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ops.letterbox import canvas_batch, dataset_canvas_size, letterbox, letterbox_params


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """OpenCV's CMYK -> RGB for JPEGs: on the values libjpeg returns (PIL
    inverts them, Adobe's polarity), each channel is k - ((255 - c) * k >> 8)."""
    c = 255 - cmyk.astype(np.int32)
    k = c[..., 3:]
    return (k - ((255 - c[..., :3]) * k >> 8)).astype(np.uint8)


def read_rgb(path: str) -> np.ndarray:
    """An image file as HWC RGB uint8, as cv2.imread(IMREAD_COLOR) decodes
    it: PIL's JPEG decoder gives the same pixels and the EXIF orientation is
    applied as cv2 applies it; 16-bit grayscale keeps its high byte and CMYK
    JPEGs convert by OpenCV's formula, where PIL's own conversions differ.
    Raises OSError where PIL cannot read it."""
    from PIL import Image, ImageOps

    with Image.open(path) as im:
        fmt = im.format
        im = ImageOps.exif_transpose(im)
        if im.mode.startswith("I;16"):
            hi = (np.asarray(im).astype(np.uint32) >> 8).astype(np.uint8)
            return np.repeat(hi[..., None], 3, axis=-1)
        if im.mode == "CMYK" and fmt == "JPEG":
            return _cmyk_to_rgb(np.asarray(im))
        return np.asarray(im.convert("RGB"))


class CocoDetection:
    """COCO-format detection dataset (host side, numpy out).

    Category ids map to contiguous class indices by sorted id; crowd
    annotations are skipped; `max_images` keeps the first images by id.
    preprocess: 'host' letterboxes each item on the CPU; 'device' returns the
    raw image with boxes in original pixels (`_getitem_raw`), and the canvas
    size is fixed here, from the annotations' image sizes.
    """

    def __init__(self, images_dir: str, ann_json: str, *, img_size: int = 640,
                 max_images: Optional[int] = None, preprocess: str = "host") -> None:
        if preprocess not in ("host", "device"):
            raise ValueError(f"preprocess must be 'host' or 'device', got {preprocess!r}")
        self.images_dir = images_dir
        self.img_size = int(img_size)
        self.preprocess = preprocess
        with open(ann_json, "r", encoding="utf-8") as f:
            ann = json.load(f)

        self.images = sorted(ann.get("images", []), key=lambda im: im["id"])
        if max_images:
            self.images = self.images[: int(max_images)]
        keep_ids = {im["id"] for im in self.images}
        self._info_by_id = {im["id"]: im for im in self.images}

        self.cat_ids = sorted(c["id"] for c in ann.get("categories", []))
        self.cat_id_to_idx = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.class_names = [c["name"] for c in sorted(ann.get("categories", []), key=lambda c: c["id"])]

        self.anns_by_image: Dict[int, List[dict]] = {im["id"]: [] for im in self.images}
        for a in ann.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            if a["image_id"] in keep_ids:
                self.anns_by_image[a["image_id"]].append(a)

        # One canvas for the whole set, so every batch has one shape.
        self.canvas_size: Optional[int] = (dataset_canvas_size(self.images, self.img_size)
                                           if preprocess == "device" else None)

    def __len__(self) -> int:
        return len(self.images)

    def image_info(self, image_id: int) -> Optional[dict]:
        """The annotations' entry of an image id (None for an unknown id)."""
        return self._info_by_id.get(image_id)

    def load_image(self, idx: int) -> np.ndarray:
        """The image as HWC RGB uint8, as cv2.imread(IMREAD_COLOR) decodes it (`read_rgb`)."""
        return read_rgb(os.path.join(self.images_dir, self.images[idx]["file_name"]))

    def _boxes_labels(self, info: dict, gain=(1.0, 1.0), pad=(0, 0)) -> Tuple[np.ndarray, np.ndarray]:
        """The image's non-crowd boxes, COCO xywh mapped to xyxy as
        x * gain + pad, and their class indices."""
        (gw, gh), (px, py) = gain, pad
        boxes, labels = [], []
        for a in self.anns_by_image.get(info["id"], []):
            x, y, w, h = a["bbox"]  # COCO xywh in original pixels
            boxes.append([x * gw + px, y * gh + py, (x + w) * gw + px, (y + h) * gh + py])
            labels.append(self.cat_id_to_idx[a["category_id"]])
        return np.asarray(boxes, np.float32).reshape(-1, 4), np.asarray(labels, np.int32).reshape(-1)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(letterboxed HWC uint8 image, target dict in letterbox space), or
        in device mode `_getitem_raw`'s item."""
        img = self.load_image(idx)
        if self.preprocess == "device":
            return self._getitem_raw(img, idx)
        lb, gain, pad = letterbox(img, self.img_size)
        info = self.images[idx]
        boxes, labels = self._boxes_labels(info, gain, pad)
        target = {
            "boxes": boxes,
            "labels": labels,
            "image_id": info["id"],
            "orig_hw": (info.get("height"), info.get("width")),
            "gain": gain,
            "pad": pad,
        }
        return np.ascontiguousarray(lb, dtype=np.uint8), target

    def _getitem_raw(self, img: np.ndarray, idx: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Device-preprocess item: the raw pixels, boxes in original
        coordinates, and the letterbox geometry (`gain`, `pad`, `new_hw`)
        that the train step applies on the device."""
        info = self.images[idx]
        h, w = int(img.shape[0]), int(img.shape[1])
        gain, pad, new_hw = letterbox_params((h, w), self.img_size)
        boxes, labels = self._boxes_labels(info)
        target = {
            "boxes": boxes,
            "labels": labels,
            "image_id": info["id"],
            "orig_hw": (h, w),
            "gain": gain,
            "pad": pad,
            "new_hw": new_hw,
        }
        return np.ascontiguousarray(img[..., :3], dtype=np.uint8), target


class Batch:
    """Fixed-shape host batch."""

    __slots__ = ("images", "gt_labels", "gt_boxes", "gt_mask", "meta")

    def __init__(self, images, gt_labels, gt_boxes, gt_mask, meta):
        self.images = images
        self.gt_labels = gt_labels
        self.gt_boxes = gt_boxes
        self.gt_mask = gt_mask
        self.meta = meta


class DeviceBatch:
    """Fixed-shape host batch for device letterboxing: raw pixels on a fixed
    canvas (image i at its top-left), per-image geometry, and boxes in
    original coordinates. The train step warps the canvas to `img_size`,
    the letterbox size the geometry was computed for, and maps the boxes on
    the device (`TrainConfig(device_preprocess=True)`)."""

    __slots__ = ("canvas", "new_hw", "pads", "hw", "gainpad", "gt_labels", "gt_boxes", "gt_mask", "meta",
                 "img_size")

    def __init__(self, canvas, new_hw, pads, hw, gainpad, gt_labels, gt_boxes, gt_mask, meta, img_size):
        self.canvas = canvas
        self.new_hw = new_hw
        self.pads = pads
        self.hw = hw
        self.gainpad = gainpad  # [B, 4] f32 (gain_w, gain_h, pad_left, pad_top)
        self.gt_labels = gt_labels
        self.gt_boxes = gt_boxes  # original pixel coordinates
        self.gt_mask = gt_mask
        self.meta = meta
        self.img_size = int(img_size)


def _pad_targets(targets: Sequence[dict], max_boxes: int):
    b = len(targets)
    gl = np.zeros((b, max_boxes), np.int32)
    gb = np.zeros((b, max_boxes, 4), np.float32)
    gm = np.zeros((b, max_boxes), bool)
    for i, t in enumerate(targets):
        n = min(len(t["labels"]), max_boxes)
        if n:
            gl[i, :n] = t["labels"][:n]
            gb[i, :n] = t["boxes"][:n]
            gm[i, :n] = True
    return gl, gb, gm, list(targets)


def collate_device(items: Sequence[Tuple[np.ndarray, dict]], max_boxes: int, img_size: int,
                   canvas_size: int) -> DeviceBatch:
    """Paste raw images onto the fixed canvas (`canvas_batch`: a copy, no
    resize, geometry for `img_size`) and pad the targets."""
    canvas, new_hw, pads, hw, metas = canvas_batch([img for img, _ in items], img_size, canvas_size=canvas_size)
    gainpad = np.asarray([(*gain, *pad) for gain, pad, _ in metas], np.float32).reshape(-1, 4)
    return DeviceBatch(canvas, new_hw, pads, hw, gainpad, *_pad_targets([t for _, t in items], max_boxes),
                       img_size)


def collate(items: Sequence[Tuple[np.ndarray, dict]], max_boxes: int) -> Batch:
    imgs = np.stack([it[0] for it in items])  # [B, S, S, 3]
    return Batch(imgs, *_pad_targets([t for _, t in items], max_boxes))


class DataLoader:
    """Threaded prefetching loader of fixed-shape batches (`Batch`, or
    `DeviceBatch` for a device-preprocess dataset).

    shuffle: each epoch's order is `np.random.RandomState(seed + epoch)`'s
    shuffle of the indices; an epoch counter advances per iteration, and
    `set_epoch` pins it (a resumed run replays epoch N's order). A last
    partial batch is padded by repeating item 0, its geometry included, with
    an empty target, and the padding's `meta` entries are None. A decode error reaches the consumer; a consumer that
    stops early stops the producer.
    """

    def __init__(self, dataset: CocoDetection, *, batch_size: int = 16, shuffle: bool = False, max_boxes: int = 128,
                 workers: int = 8, prefetch: int = 4, seed: int = 0) -> None:
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.max_boxes = int(max_boxes)
        self.workers = max(1, int(workers))
        self.prefetch = max(1, int(prefetch))
        self.seed = seed
        self._epoch = 0
        self.canvas_size = getattr(dataset, "canvas_size", None)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch of the next iteration."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return (len(self.ds) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Union[Batch, DeviceBatch]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        batches = [order[s:s + self.batch_size].tolist() for s in range(0, len(order), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """A bounded put that keeps polling the stop flag, so an abandoned
            consumer does not leave this thread parked on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # Any error (a missing or corrupt file) goes to the consumer and
            # is raised there: a dead producer would leave it blocked on get().
            try:
                with ThreadPoolExecutor(max_workers=self.workers) as pool:
                    for chunk in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.ds.__getitem__, chunk))
                        n_pad = self.batch_size - len(items)
                        if n_pad > 0:
                            empty = {**items[0][1], "boxes": np.zeros((0, 4), np.float32),
                                     "labels": np.zeros((0,), np.int32), "image_id": -1}
                            items += [(items[0][0], empty)] * n_pad
                        if self.canvas_size is not None:
                            batch = collate_device(items, self.max_boxes, self.ds.img_size, self.canvas_size)
                        else:
                            batch = collate(items, self.max_boxes)
                        for j in range(self.batch_size - n_pad, self.batch_size):
                            batch.meta[j] = None
                        if not put_or_stop(batch):
                            return
                put_or_stop(None)
            except BaseException as e:  # noqa: BLE001 — relayed to the consumer, not swallowed
                put_or_stop(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
