"""COCO detection dataset and a prefetching fixed-shape batch loader.

Counterpart of the validation half of the JAX package's
`leanyolo_tpu/data/dataset.py`:

- annotations are indexed once, at construction;
- images decode with PIL and letterbox on the host with the port's
  cv2-free `letterbox` (cv2's pixels, bit for bit);
- batches are fixed-shape: images [B, S, S, 3] uint8 NHWC plus padded
  targets (labels [B, Nmax], boxes [B, Nmax, 4], mask [B, Nmax]);
- a thread pool decodes a batch while the consumer works on the last one.

Training's half (shuffling, epochs, dropping the last batch, the raw-image
items and canvas batches of device letterboxing) is not ported yet.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.letterbox import letterbox


class CocoDetection:
    """COCO-format detection dataset (host side, numpy out).

    Category ids map to contiguous class indices by sorted id; crowd
    annotations are skipped; `max_images` keeps the first images by id.
    """

    def __init__(self, images_dir: str, ann_json: str, *, img_size: int = 640,
                 max_images: Optional[int] = None) -> None:
        self.images_dir = images_dir
        self.img_size = int(img_size)
        with open(ann_json, "r", encoding="utf-8") as f:
            ann = json.load(f)

        self.images = sorted(ann.get("images", []), key=lambda im: im["id"])
        if max_images:
            self.images = self.images[: int(max_images)]
        keep_ids = {im["id"] for im in self.images}

        self.cat_ids = sorted(c["id"] for c in ann.get("categories", []))
        self.cat_id_to_idx = {cid: i for i, cid in enumerate(self.cat_ids)}
        self.class_names = [c["name"] for c in sorted(ann.get("categories", []), key=lambda c: c["id"])]

        self.anns_by_image: Dict[int, List[dict]] = {im["id"]: [] for im in self.images}
        for a in ann.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            if a["image_id"] in keep_ids:
                self.anns_by_image[a["image_id"]].append(a)

    def __len__(self) -> int:
        return len(self.images)

    def load_image(self, idx: int) -> np.ndarray:
        """The image as HWC RGB uint8, as cv2.imread decodes it: PIL's JPEG
        decoder gives the same pixels, and the EXIF orientation is applied
        as cv2 applies it."""
        from PIL import Image, ImageOps

        path = os.path.join(self.images_dir, self.images[idx]["file_name"])
        with Image.open(path) as im:
            return np.asarray(ImageOps.exif_transpose(im).convert("RGB"))

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(letterboxed HWC uint8 image, target dict in letterbox space)."""
        img = self.load_image(idx)
        lb, (gw, gh), (px, py) = letterbox(img, self.img_size)
        info = self.images[idx]
        boxes, labels = [], []
        for a in self.anns_by_image.get(info["id"], []):
            x, y, w, h = a["bbox"]  # COCO xywh in original pixels
            boxes.append([x * gw + px, y * gh + py, (x + w) * gw + px, (y + h) * gh + py])
            labels.append(self.cat_id_to_idx[a["category_id"]])
        target = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int32).reshape(-1),
            "image_id": info["id"],
            "orig_hw": (info.get("height"), info.get("width")),
            "gain": (gw, gh),
            "pad": (px, py),
        }
        return np.ascontiguousarray(lb, dtype=np.uint8), target


class Batch:
    """Fixed-shape host batch."""

    __slots__ = ("images", "gt_labels", "gt_boxes", "gt_mask", "meta")

    def __init__(self, images, gt_labels, gt_boxes, gt_mask, meta):
        self.images = images
        self.gt_labels = gt_labels
        self.gt_boxes = gt_boxes
        self.gt_mask = gt_mask
        self.meta = meta


def collate(items: Sequence[Tuple[np.ndarray, dict]], max_boxes: int) -> Batch:
    imgs = np.stack([it[0] for it in items])  # [B, S, S, 3]
    b = len(items)
    gl = np.zeros((b, max_boxes), np.int32)
    gb = np.zeros((b, max_boxes, 4), np.float32)
    gm = np.zeros((b, max_boxes), bool)
    meta = []
    for i, (_, t) in enumerate(items):
        n = min(len(t["labels"]), max_boxes)
        if n:
            gl[i, :n] = t["labels"][:n]
            gb[i, :n] = t["boxes"][:n]
            gm[i, :n] = True
        meta.append(t)
    return Batch(imgs, gl, gb, gm, meta)


class DataLoader:
    """Threaded prefetching loader of fixed-shape batches, in dataset order.

    The last partial batch is padded by repeating item 0 with an empty
    target; the padding's `meta` entries are None. A decode error reaches
    the consumer; a consumer that stops early stops the producer.
    """

    def __init__(self, dataset: CocoDetection, *, batch_size: int = 16, max_boxes: int = 128, workers: int = 8,
                 prefetch: int = 4) -> None:
        self.ds = dataset
        self.batch_size = int(batch_size)
        self.max_boxes = int(max_boxes)
        self.workers = max(1, int(workers))
        self.prefetch = max(1, int(prefetch))

    def __len__(self) -> int:
        return (len(self.ds) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        batches = [list(range(s, min(s + self.batch_size, len(self.ds))))
                   for s in range(0, len(self.ds), self.batch_size)]
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
