"""Batched COCO validation: the predictor's forward and decode, the numpy
COCO mAP, and the throughput of the run.

Counterpart of the JAX package's `leanyolo_tpu/engine/validator.py`:

- fixed-shape batches through `Predictor.run_batch` (or `run_canvas` when
  the letterbox runs on the device);
- pipelined one batch deep: batch i+1 is dispatched before batch i's
  detections are read back and scored, and the readback of batch i waits
  only for batch i (a copy to pinned memory behind it, with an event);
- `measure_fps` times `run_batch` on the predictor's device.

- `viz_dir`: the detections drawn (utils/viz.py) and saved per image, in
  the consumer behind the device as JAX's: on the letterboxed pixels under
  the host letterbox, on the original images with the boxes mapped back
  under the device letterbox, named by file, image id or index.

Parallel, as JAX's: `mesh=` splits every batch over the mesh's data axes
(`Predictor(mesh=)`, with a `space` or `model` axis too) and every process
scores all of it;
`shard=(pid, nprocs)` gives each process a stride slice of the image list (no
image dropped), run on its own device with no collective per batch, and one
`allgather_obj` merges the detections for process 0 to score
(`_finish_sharded`): every process returns the same stats, with the slowest
shard's wall time.

It runs on the card unless the caller names another device, and raises
without one.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.dataset import CocoDetection, DataLoader
from ..models.yolov10.model import YOLOv10
from ..ops.letterbox import canvas_batch, dataset_canvas_size
from ..utils.coco_eval import CocoEvaluator
from ..utils.viz import draw_detections, save_image
from .predictor import Predictor


def detections_to_coco_arrays(
    dets: np.ndarray,
    num: np.ndarray,
    metas: Sequence[Optional[dict]],
    cat_ids: Sequence[int],
    *,
    decode: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-shape detections -> columnar COCO results (xywh, original
    pixels): (image_ids [N], category_ids [N], boxes_xywh [N,4], scores [N]).

    Numpy column math over the whole batch; class index -> dataset
    category_id by sorted id. Padding images (meta None) give no rows. The
    top-k decode keeps all its rows, as the COCO protocol wants; the NMS
    decode keeps the first `num` of each image.
    """
    real = [i for i, m in enumerate(metas) if m is not None]
    if not real:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros((0, 4), np.float32),
            np.zeros(0, np.float32),
        )
    d = np.asarray(dets)[real]  # [n, A, 6]
    nim, A = d.shape[0], d.shape[1]
    gains = np.asarray([metas[i]["gain"] for i in real], np.float32)
    pads = np.asarray([metas[i]["pad"] for i in real], np.float32)
    ohw = np.asarray([metas[i]["orig_hw"] for i in real], np.float32)
    ids = np.asarray([metas[i]["image_id"] for i in real], np.int64)
    if decode == "topk":
        valid = np.ones((nim, A), bool)
    else:
        valid = np.arange(A)[None, :] < np.asarray(num)[real][:, None]
    gw, gh = gains[:, :1], gains[:, 1:2]
    px, py = pads[:, :1], pads[:, 1:2]
    oh, ow = ohw[:, :1], ohw[:, 1:2]
    x1 = np.clip((d[:, :, 0] - px) / gw, 0, ow)
    y1 = np.clip((d[:, :, 1] - py) / gh, 0, oh)
    x2 = np.clip((d[:, :, 2] - px) / gw, 0, ow)
    y2 = np.clip((d[:, :, 3] - py) / gh, 0, oh)
    boxes = np.stack((x1, y1, x2 - x1, y2 - y1), axis=-1)[valid]
    img_col = np.broadcast_to(ids[:, None], (nim, A))[valid]
    cat_col = np.asarray(cat_ids, np.int64)[d[:, :, 5].astype(np.int64)][valid]
    scores = d[:, :, 4][valid]
    return img_col, cat_col, boxes.astype(np.float32, copy=False), scores.astype(np.float32, copy=False)


def detections_to_coco_results(
    dets: np.ndarray,
    num: np.ndarray,
    metas: Sequence[Optional[dict]],
    cat_ids: Sequence[int],
    *,
    decode: str,
) -> List[dict]:
    """COCO result dicts: a thin wrapper over `detections_to_coco_arrays`,
    for a JSON boundary; the validation loop itself stays columnar."""
    img_col, cat_col, boxes, scores = detections_to_coco_arrays(dets, num, metas, cat_ids, decode=decode)
    return [
        {"image_id": i, "category_id": c, "bbox": b, "score": s}
        for i, c, b, s in zip(img_col.tolist(), cat_col.tolist(), boxes.tolist(), scores.tolist())
    ]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_fps(predictor: Predictor, *, batch_size: int = 1, warmup: int = 1, iters: int = 30) -> float:
    """Images per second of `predictor.run_batch` on its device: `warmup`
    calls on uint8 zeros, then `iters` calls on a batch filled with 114,
    timed on the host clock after the device has finished."""
    shape = (batch_size, predictor.imgsz, predictor.imgsz, 3)
    x0 = torch.zeros(shape, dtype=torch.uint8, device=predictor.device)
    x1 = torch.full(shape, 114, dtype=torch.uint8, device=predictor.device)
    for _ in range(max(1, warmup)):
        predictor.run_batch(x0)
    _sync(predictor.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        dets, _num = predictor.run_batch(x1)
    _sync(predictor.device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(dets).all()):
        raise RuntimeError("measure_fps: the predictor returned non-finite detections")
    return (iters * batch_size) / dt


def _readback(dets: torch.Tensor, num: torch.Tensor):
    """Queue one batch's detections for the host behind the work that makes
    them: (dets, num, event), on the card pinned host tensors that are
    complete once the event has fired."""
    if dets.device.type != "cuda":
        return dets, num, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (dets, num)]
    for h, t in zip(host, (dets, num)):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host[0], host[1], event


def _viz_name(ds: CocoDetection, m: dict, idx: int, name_mode: str) -> str:
    """A drawn image's file name: 'id' -> <image_id>.jpg, 'index' ->
    <idx:06d>.jpg, 'file' -> the image's own file name (<idx:06d>.jpg where
    the annotations have no entry for it)."""
    if name_mode == "id":
        return f"{m['image_id']}.jpg"
    if name_mode == "index":
        return f"{idx:06d}.jpg"
    info = ds.image_info(m["image_id"])
    return os.path.basename(info["file_name"]) if info else f"{idx:06d}.jpg"


def _viz_rows(d: np.ndarray, n: int, decode: str, conf: float) -> np.ndarray:
    return d[:n] if decode != "topk" else d[d[:, 4] > conf]


def _save_viz_batch(images, dets, num, metas, ds, *, decode, viz_dir, conf, name_mode, start_index) -> int:
    """Draw on the letterboxed batch images (the host letterbox); returns the next index."""
    os.makedirs(viz_dir, exist_ok=True)
    idx = start_index
    for i, m in enumerate(metas):
        if m is None:
            continue
        d = _viz_rows(dets[i], int(num[i]), decode, conf)
        out = draw_detections(np.asarray(images[i], np.uint8), d, ds.class_names)
        save_image(os.path.join(viz_dir, _viz_name(ds, m, idx, name_mode)), out)
        idx += 1
    return idx


def _save_viz_original(raw_imgs, dets, num, metas, ds, *, decode, viz_dir, conf, name_mode, start_index) -> int:
    """Draw on the original images, the boxes mapped back with the letterbox
    inverse and clipped to the image (the device letterbox, whose
    letterboxed pixels stay on the device); returns the next index."""
    os.makedirs(viz_dir, exist_ok=True)
    idx = start_index
    for i, m in enumerate(metas):
        if m is None:
            continue
        d = _viz_rows(np.array(dets[i], copy=True), int(num[i]), decode, conf)
        gw, gh = m["gain"]
        px, py = m["pad"]
        oh, ow = m["orig_hw"]
        d[:, 0] = np.clip((d[:, 0] - px) / gw, 0, ow)
        d[:, 1] = np.clip((d[:, 1] - py) / gh, 0, oh)
        d[:, 2] = np.clip((d[:, 2] - px) / gw, 0, ow)
        d[:, 3] = np.clip((d[:, 3] - py) / gh, 0, oh)
        out = draw_detections(np.asarray(raw_imgs[i], np.uint8), d, ds.class_names)
        save_image(os.path.join(viz_dir, _viz_name(ds, m, idx, name_mode)), out)
        idx += 1
    return idx


def validate_coco(
    model: YOLOv10,
    *,
    images_dir: str,
    ann_json: str,
    imgsz: int = 640,
    batch_size: int = 16,
    decode: str = "topk",
    conf_thresh: float = 0.001,
    iou_thresh: float = 0.65,
    max_det: int = 300,
    max_images: Optional[int] = None,
    dtype: str = "float32",
    workers: int = 8,
    class_wise_nms: bool = False,
    save_detections: Optional[str] = None,
    measure_speed: bool = False,
    fps_warmup: int = 1,
    predictor: Optional[Predictor] = None,
    viz_dir: Optional[str] = None,
    viz_conf: float = 0.25,
    viz_name_mode: str = "file",
    preprocess: str = "host",
    device: Optional[Union[str, torch.device]] = None,
    mesh=None,
    shard: Optional[Tuple[int, int]] = None,
) -> Dict[str, float]:
    """Run COCO bbox validation; returns {'map_50_95', 'map_50', 'map_75',
    'map_small', 'map_medium', 'map_large', 'n_images', 'wall_s',
    'throughput_ips'} (and 'fps' with measure_speed).

    The top-k decode keeps everything it emits (conf is not applied, as the
    COCO protocol wants); the NMS decode applies conf_thresh and iou_thresh.
    `predictor`: reuse one (its weights are replaced by `model`'s through
    `update_params`); it must have this call's decode and imgsz. Otherwise
    an unfolded predictor in `dtype` is built on `device` (None: the card,
    raising without one). preprocess: 'host' (the loader letterboxes with
    the numpy letterbox) or 'device' (images pasted on a canvas, the
    letterbox warped on the predictor's device). viz_dir: draw each image's
    detections (top-k: those above viz_conf; NMS: the first num) and save
    them there, named by viz_name_mode: 'file' (the image's file name), 'id'
    (<image_id>.jpg) or 'index' (sequential). mesh: batches split over a
    DeviceMesh's data axes, images' rows over its `space` axis or layers'
    channels over its `model` axis (a new predictor's); batch_size must
    divide by the data axes' processes. shard=(pid, nprocs): this
    process evaluates images pid, pid + nprocs, ... and the stats are the
    whole set's (every process must call).
    """
    if preprocess not in ("host", "device"):
        raise ValueError(f"unknown preprocess {preprocess!r}: 'host' or 'device'")
    if viz_name_mode not in ("file", "id", "index"):
        raise ValueError(f"unknown viz_name_mode {viz_name_mode!r}: 'file', 'id' or 'index'")
    if mesh is not None:
        from ..parallel.mesh import data_position

        n_data = data_position(mesh)[0]
        if batch_size % n_data:
            raise ValueError(f"batch_size {batch_size} not divisible by the mesh's {n_data} data-parallel processes")
    ds = CocoDetection(images_dir, ann_json, img_size=imgsz, max_images=max_images)
    sharded = shard is not None and shard[1] > 1
    if sharded:
        # Unequal shards are fine (no collective per batch); dropping an image would change the mAP.
        pid, nprocs = shard
        ds.images = ds.images[pid::nprocs]
    if predictor is None:
        predictor = Predictor(model, imgsz=imgsz, decode=decode, conf_thresh=conf_thresh, iou_thresh=iou_thresh,
                              max_det=max_det, class_wise_nms=class_wise_nms, dtype=dtype, device=device,
                              mesh=mesh)
    else:
        if (predictor.decode, predictor.imgsz) != (decode, imgsz):
            raise ValueError(f"predictor has decode {predictor.decode!r} and imgsz {predictor.imgsz}; this call "
                             f"asks for {decode!r} and {imgsz}")
        predictor.update_params(model)

    chunks: List[tuple] = []  # columnar per-batch results, for the JSON
    n_images = 0
    viz_index = 0
    # Sharded, the chunks are merged first and process 0 scores them once.
    evaluator = None if sharded else CocoEvaluator(_load_gt(ann_json, max_images))
    t0 = time.perf_counter()

    def _consume(dets_h, num_h, event, metas, viz) -> None:
        """Host work for one batch (readback, conversion, incremental
        scoring, drawing), done while the next batch runs on the device."""
        nonlocal n_images, viz_index
        if event is not None:
            event.synchronize()
        dets, num = dets_h.numpy(), num_h.numpy()
        cols = detections_to_coco_arrays(dets, num, metas, ds.cat_ids, decode=decode)
        chunks.append(cols)
        if evaluator is not None:
            evaluator.add_detections_arrays(*cols)
            evaluator.score_images([m["image_id"] for m in metas if m is not None])
        if viz_dir:
            kind, images = viz
            save = _save_viz_batch if kind == "batch" else _save_viz_original
            viz_index = save(images, dets, num, metas, ds, decode=decode, viz_dir=viz_dir, conf=viz_conf,
                             name_mode=viz_name_mode, start_index=viz_index)
        n_images += sum(m is not None for m in metas)

    pending = None
    if preprocess == "device":
        batches = _iter_device_preprocess(ds, predictor, batch_size, workers)
    else:
        batches = _iter_host_preprocess(ds, predictor, batch_size, workers)
    for dets, num, metas, viz in batches:
        out = (*_readback(dets, num), metas, viz)
        if pending is not None:
            _consume(*pending)
        pending = out
    if pending is not None:
        _consume(*pending)
    wall = time.perf_counter() - t0
    if sharded:
        return _finish_sharded(chunks, n_images, wall, ann_json, max_images, save_detections, measure_speed,
                               fps_warmup, predictor)
    return _finish(chunks, evaluator, n_images, wall, save_detections, measure_speed, fps_warmup, predictor)


def _iter_host_preprocess(ds: CocoDetection, predictor: Predictor, batch_size: int, workers: int):
    """Yield (dets, num, metas, ("batch", letterboxed images)) per batch,
    letterboxed on the host by the loader; dets and num stay on the device
    (the caller reads them back)."""
    loader = DataLoader(ds, batch_size=batch_size, workers=workers, max_boxes=1)
    for batch in loader:
        dets, num = predictor.run_batch(batch.images)
        metas = [
            None if m is None
            else {"image_id": m["image_id"], "gain": m["gain"], "pad": m["pad"], "orig_hw": m["orig_hw"]}
            for m in batch.meta
        ]
        yield dets, num, metas, ("batch", batch.images)


def _iter_device_preprocess(ds: CocoDetection, predictor: Predictor, batch_size: int, workers: int):
    """Yield (dets, num, metas, ("original", decoded images)) per batch with
    the letterbox done on the predictor's device.

    Decoded images go onto a fixed canvas (a host copy only); the resize and
    pad run in `run_canvas`. The canvas size comes from the annotations'
    image sizes, so every batch has one shape.
    """
    canvas_size = dataset_canvas_size(ds.images, ds.img_size)
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        for s in range(0, len(ds), batch_size):
            idxs = list(range(s, min(s + batch_size, len(ds))))
            imgs = list(pool.map(ds.load_image, idxs))
            n_real = len(imgs)
            imgs += [imgs[0]] * (batch_size - n_real)  # fixed-shape padding
            canvas, new_hw, pads, hw, cmetas = canvas_batch(imgs, ds.img_size, canvas_size=canvas_size)
            dets, num = predictor.run_canvas(canvas, new_hw, pads, hw)
            metas = [
                {"image_id": ds.images[idxs[i]]["id"], "gain": cmetas[i][0], "pad": cmetas[i][1],
                 "orig_hw": cmetas[i][2]}
                if i < n_real else None
                for i in range(batch_size)
            ]
            yield dets, num, metas, ("original", imgs)


def _load_gt(ann_json: str, max_images: Optional[int]) -> dict:
    with open(ann_json, "r", encoding="utf-8") as f:
        gt = json.load(f)
    if max_images:
        keep = {im["id"] for im in sorted(gt["images"], key=lambda im: im["id"])[: int(max_images)]}
        gt = {
            "images": [im for im in gt["images"] if im["id"] in keep],
            "annotations": [a for a in gt["annotations"] if a["image_id"] in keep],
            "categories": gt["categories"],
        }
    return gt


def _finish_sharded(chunks, n_images, wall, ann_json, max_images, save_detections, measure_speed, fps_warmup,
                    predictor):
    """Merge every process's columnar detections (one allgather_obj of
    plain lists), score them once on process 0 (which alone writes
    save_detections and measures fps), then share its stats: every process
    returns the same numbers. The wall time is the slowest shard's."""
    from ..parallel.distributed import allgather_obj, process_index

    payload = [tuple(col.tolist() for col in c) for c in chunks]
    merged = allgather_obj({"c": payload, "n": n_images, "w": wall})
    chunks = [
        (np.asarray(c[0], np.int64), np.asarray(c[1], np.int64), np.asarray(c[2], np.float32).reshape(-1, 4),
         np.asarray(c[3], np.float32))
        for m in merged
        for c in m["c"]
    ]
    n_images = sum(m["n"] for m in merged)
    wall = max(m["w"] for m in merged)
    stats = None
    if process_index() == 0:
        evaluator = CocoEvaluator(_load_gt(ann_json, max_images))
        for c in chunks:
            evaluator.add_detections_arrays(*c)
        stats = _finish(chunks, evaluator, n_images, wall, save_detections, measure_speed, fps_warmup, predictor)
    return allgather_obj(stats)[0]


def _finish(chunks, evaluator, n_images, wall, save_detections, measure_speed, fps_warmup, predictor):
    if save_detections:
        # The one per-detection Python loop, at the JSON boundary (COCO's
        # result dicts).
        os.makedirs(os.path.dirname(os.path.abspath(save_detections)), exist_ok=True)
        results = [
            {"image_id": i, "category_id": c, "bbox": b, "score": s}
            for img_col, cat_col, boxes, scores in chunks
            for i, c, b, s in zip(img_col.tolist(), cat_col.tolist(), boxes.tolist(), scores.tolist())
        ]
        with open(save_detections, "w", encoding="utf-8") as f:
            json.dump(results, f)

    stats = evaluator.evaluate()
    stats["n_images"] = n_images
    stats["wall_s"] = wall
    stats["throughput_ips"] = n_images / wall if wall > 0 else 0.0
    if measure_speed:
        stats["fps"] = measure_fps(predictor, batch_size=1, warmup=fps_warmup)
    return stats
