"""Fixed-shape serving export: a `torch.export` program with the port's
kernels in it, a JSON sidecar, and bucketed serving of any image size.

Counterpart of the JAX package's `leanyolo_tpu/export/serving.py`, with the
same serving contract:

    detections [N, max_dets, 6]  ([x1, y1, x2, y2, score, cls])
    num_dets   [N] int32

- topk: the best class per anchor on the sigmoid scores (the fused
  max/argmax kernel, fp32 two-reduce route: `jnp.max` and the first
  `jnp.argmax`), masked to -1 below conf, the top min(max_dets, anchors)
  (the top-k kernel), boxes clamped to [0, imgsz], unmasked scores,
  num = count >= conf;
- nms: the top min(pre_topk, anchors * nc) (anchor, class) pairs by
  sigmoid score (the top-k kernel over [B, A * nc]), one class-wise greedy
  NMS pass (the NMS kernel, class offset 81920), boxes clamped.

Ranking runs on the sigmoid scores, not on the logits: above a logit of
about 16.6 fp32 sigmoid saturates to 1.0 and ties go to the lower index,
where a logit ranking would not tie.

The artifact is `torch.export.export` of the serving module (the folded
weights are its state, the packed kernel weights among its constants) with
a symbolic batch dimension, saved with `torch.export.save` as `<out>.pt2`.
Each kernel is the operator `leanyolo_tpu_torch::<name>` in the program;
loading it needs the operators registered, which `load_exported` does by
importing `leanyolo_tpu_torch.kernels`' modules. An artifact exported on
the card runs on the card.
"""

from __future__ import annotations

import copy
import json
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..models.yolov10.decode import _flatten_pyramid, _nms_single, postprocess_to_original
from ..models.yolov10.fold import fold_model
from ..models.yolov10.model import YOLOv10
from ..ops.letterbox import choose_bucket, letterbox
from ..ops.topk import max_argmax_lastdim, topk_lastdim
from ..version import __version__

_DTYPES = {"float32": torch.float32, "fp32": torch.float32, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}
GROUP_OFFSET = 8192.0 * 10.0  # the class offset of the NMS route (JAX serving.py:122)
LOAD_NOTE = ("load with leanyolo_tpu_torch.export.serving.load_exported, or torch.export.load after importing "
             "leanyolo_tpu_torch.kernels' modules (stem, dwconv, s2dconv, matmul, topk, argmax, nms), which "
             "register the leanyolo_tpu_torch:: operators the program calls")


def _device(device: Optional[Union[str, torch.device]]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("serving export: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


class ServingModule(nn.Module):
    """images float32 [B, S, S, 3], 0-255 RGB -> (detections [B, max_dets,
    6] fp32, num_dets [B] int32). `model` is folded (normalize=False) or not."""

    def __init__(self, model: YOLOv10, *, imgsz: int, decode: str, max_dets: int, conf: float, iou: float,
                 pre_topk: int, dtype: torch.dtype, normalize: bool) -> None:
        super().__init__()
        self.model = model
        self.imgsz, self.max_dets, self.pre_topk = int(imgsz), int(max_dets), int(pre_topk)
        self.conf, self.iou = float(conf), float(iou)
        self.use_nms = decode.lower() == "nms"
        self.dtype, self.normalize = dtype, normalize

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        branch = "one2many" if self.use_nms else "one2one"
        cfg, nc = self.model.cfg, self.model.nc
        raw = self.model(images.to(self.dtype), dtype=self.dtype, branches=(branch,), normalize=self.normalize,
                         concat_head=False)[branch]
        boxes, cls_logits = _flatten_pyramid([(r.float(), c.float()) for r, c in raw], nc, cfg.strides)
        scores = torch.sigmoid(cls_logits)  # [B, A, nc]
        b, a = scores.shape[0], scores.shape[1]
        if not self.use_nms:
            best_scores, best_cls = max_argmax_lastdim([scores])
            masked = torch.where(best_scores >= self.conf, best_scores, torch.full_like(best_scores, -1.0))
            k = min(self.max_dets, a)
            _, top_idx = topk_lastdim(masked, k)
            top_idx = top_idx.long()
            sel_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4)).clamp(0.0, float(self.imgsz))
            sel_scores = torch.gather(best_scores, 1, top_idx).clamp_min(0.0)  # unmasked, as JAX's
            sel_cls = torch.gather(best_cls, 1, top_idx).float()
            dets = torch.cat([sel_boxes, sel_scores[..., None], sel_cls[..., None]], dim=-1)
            if k < self.max_dets:
                dets = torch.nn.functional.pad(dets, (0, 0, 0, self.max_dets - k))
            return dets, (sel_scores >= self.conf).sum(dim=1).to(torch.int32)
        k_pre = min(self.pre_topk, a * nc)
        cand_scores, pre_idx = topk_lastdim(scores.reshape(b, a * nc), k_pre)
        pre_idx = pre_idx.long()
        anc_idx = torch.div(pre_idx, nc, rounding_mode="floor")
        cand_cls = (pre_idx % nc).float()
        cand_boxes = torch.gather(boxes, 1, anc_idx[..., None].expand(-1, -1, 4))
        dets, num = _nms_single(cand_boxes, cand_scores, cand_cls, iou_thresh=self.iou, conf_thresh=self.conf,
                                max_det=self.max_dets, class_wise=True, group_offset=GROUP_OFFSET)
        return torch.cat([dets[..., :4].clamp(0.0, float(self.imgsz)), dets[..., 4:]], dim=-1), num


def build_serving_fn(model: YOLOv10, *, imgsz: int = 640, decode: str = "topk", max_dets: int = 300,
                     conf: float = 0.25, iou: float = 0.45, pre_topk: int = 1000, dtype: str = "float32",
                     fuse: bool = True, prefolded: bool = False,
                     device: Optional[Union[str, torch.device]] = None):
    """(fn, params): `fn` the serving module on `device` (None: the card),
    eval mode, taking float32 [B, imgsz, imgsz, 3] raw RGB pixels; `params`
    its folded (or, with fuse=False, unfolded) model's state dict.

    fuse folds BN, RepVGGDW and the input normalization into the convs (a
    copy; in bf16 the folded weights are cast once), and the model runs the
    port's kernels; `prefolded=True` declares `model` folded already (the
    bucketed export folds once)."""
    if imgsz % 32:
        raise ValueError("imgsz must be divisible by 32")
    if decode.lower() not in ("topk", "nms"):
        raise ValueError(f"unknown decode {decode!r}: 'topk' or 'nms'")
    if dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    dev, cdt = _device(device), _DTYPES[dtype]
    if fuse and not prefolded:
        model = fold_model(model, dtype=cdt if cdt == torch.bfloat16 else None)
    elif not fuse:
        model = copy.deepcopy(model)
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    fn = ServingModule(model, imgsz=imgsz, decode=decode, max_dets=max_dets, conf=conf, iou=iou, pre_topk=pre_topk,
                       dtype=cdt, normalize=not fuse).eval()
    return fn, model.state_dict()


def _meta(model: YOLOv10, *, imgsz, decode, max_dets, conf, iou, pre_topk, dtype, dynamic_batch) -> dict:
    return {
        "leanyolo_version": __version__,
        "format": "torch.export",
        "torch_version": torch.__version__,
        "load": LOAD_NOTE,
        "model_name": model.cfg.name,
        "class_names": model.class_names,
        "imgsz": imgsz,
        "decode": decode,
        "max_dets": max_dets,
        "conf": conf,
        "iou": iou,
        "pre_topk": pre_topk,
        "dtype": dtype,
        "dynamic_batch": dynamic_batch,
        "outputs": {"detections": [None if dynamic_batch else 1, max_dets, 6],
                    "num_dets": [None if dynamic_batch else 1]},
        "input": {"images": [None if dynamic_batch else 1, imgsz, imgsz, 3], "layout": "NHWC", "range": "0-255 RGB"},
    }


def export_program(fn: ServingModule, *, dynamic_batch: bool = True):
    """`torch.export.export` of a serving module (`build_serving_fn`'s) on
    float32 pixels on its device: a symbolic batch from 1 to 4096 with
    dynamic_batch (traced at 2, since a traced 1 would specialize), else
    batch 1."""
    dev = next(fn.parameters()).device
    example = torch.zeros(2 if dynamic_batch else 1, fn.imgsz, fn.imgsz, 3, dtype=torch.float32, device=dev)
    dynamic = {"images": {0: torch.export.Dim("batch", min=1, max=4096)}} if dynamic_batch else None
    with torch.no_grad():
        return torch.export.export(fn, (example,), dynamic_shapes=dynamic)


def export_serving(model: YOLOv10, out_path: str, *, imgsz: int = 640, decode: str = "topk", max_dets: int = 300,
                   conf: float = 0.25, iou: float = 0.45, pre_topk: int = 1000, dtype: str = "float32",
                   dynamic_batch: bool = True, fuse: bool = True, prefolded: bool = False,
                   device: Optional[Union[str, torch.device]] = None) -> str:
    """Export the serving module with `torch.export` (a symbolic batch
    dimension with dynamic_batch, else batch 1), save it to `<out>.pt2`
    with a JSON sidecar `<out>.pt2.json`; returns the artifact's path."""
    fn, _ = build_serving_fn(model, imgsz=imgsz, decode=decode, max_dets=max_dets, conf=conf, iou=iou,
                             pre_topk=pre_topk, dtype=dtype, fuse=fuse, prefolded=prefolded, device=device)
    exported = export_program(fn, dynamic_batch=dynamic_batch)
    if not out_path.endswith(".pt2"):
        out_path = out_path + ".pt2"
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(exported, out_path)
    meta = _meta(fn.model, imgsz=imgsz, decode=decode, max_dets=max_dets, conf=conf, iou=iou, pre_topk=pre_topk,
                 dtype=dtype, dynamic_batch=dynamic_batch)
    with open(out_path + ".json", "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2)
    return out_path


def load_exported(path: str):
    """Load a `.pt2` artifact (registering the port's operators first) and
    return its callable: images -> (detections, num_dets)."""
    from ..kernels import argmax, dwconv, matmul, nms, s2dconv, stem, topk  # noqa: F401  (register the operators)

    return torch.export.load(path).module()


def export_serving_bucketed(model: YOLOv10, out_dir: str, *, sizes: Sequence[int] = (640, 960, 1280),
                            decode: str = "topk", max_dets: int = 300, conf: float = 0.25, iou: float = 0.45,
                            pre_topk: int = 1000, dtype: str = "float32", dynamic_batch: bool = True,
                            fuse: bool = True, device: Optional[Union[str, torch.device]] = None) -> str:
    """One artifact per stride-32 size bucket, `<name>_<decode>_<size>.pt2`
    (+ `.json`), and `manifest.json` (returned): a request letterboxes into
    the smallest bucket that fits its long side and runs that artifact
    (`BucketedServing`). The model is folded once for all buckets."""
    sizes = sorted({int(s) for s in sizes})
    if any(s % 32 for s in sizes):
        raise ValueError(f"bucket sizes must be stride-32 divisible: {sizes}")
    prefolded = False
    if fuse:
        model = fold_model(model, dtype=_DTYPES[dtype] if _DTYPES[dtype] == torch.bfloat16 else None)
        prefolded = True
    buckets = {}
    for s in sizes:
        path = export_serving(model, os.path.join(out_dir, f"{model.cfg.name}_{decode}_{s}"), imgsz=s,
                              decode=decode, max_dets=max_dets, conf=conf, iou=iou, pre_topk=pre_topk, dtype=dtype,
                              dynamic_batch=dynamic_batch, fuse=fuse, prefolded=prefolded, device=device)
        buckets[str(s)] = os.path.basename(path)
    manifest = {
        "leanyolo_version": __version__,
        "format": "torch.export-bucketed",
        "torch_version": torch.__version__,
        "load": LOAD_NOTE,
        "model_name": model.cfg.name,
        "class_names": model.class_names,
        "decode": decode,
        "max_dets": max_dets,
        "conf": conf,
        "dynamic_batch": dynamic_batch,
        "buckets": buckets,
        "policy": "letterbox into the smallest bucket >= max(h, w); larger images downscale into the largest bucket",
    }
    mpath = os.path.join(out_dir, "manifest.json")
    with open(mpath, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
    return mpath


class BucketedServing:
    """Serve images of any size from a bucketed export's manifest: per image
    the bucket (`choose_bucket` over the manifest's sizes), the host
    letterbox into it, that bucket's artifact on the batch of the bucket's
    images (one at a time for static-batch artifacts), and the boxes mapped
    back to the original image. Artifacts load at first use."""

    def __init__(self, manifest_path: str) -> None:
        with open(manifest_path, "r", encoding="utf-8") as f:
            self.meta = json.load(f)
        base = os.path.dirname(os.path.abspath(manifest_path))
        self.sizes = sorted(int(s) for s in self.meta["buckets"])
        self._paths = {int(s): os.path.join(base, name) for s, name in self.meta["buckets"].items()}
        self._fns = {}

    def _fn(self, size: int):
        if size not in self._fns:
            self._fns[size] = load_exported(self._paths[size])
        return self._fns[size]

    def predict_images(self, images_rgb: Sequence[np.ndarray], *, apply_conf_filter: bool = True
                       ) -> List[np.ndarray]:
        """HWC RGB uint8 images of any sizes -> per image [k, 6] arrays
        (x1, y1, x2, y2, score, cls) in its own coordinates."""
        images_rgb = list(images_rgb)
        conf = float(self.meta.get("conf", 0.25))
        decode = self.meta.get("decode", "topk")
        chunk = None if self.meta.get("dynamic_batch", True) else 1
        by_bucket = {}
        for i, img in enumerate(images_rgb):
            by_bucket.setdefault(choose_bucket(img.shape[:2], self.sizes, max(self.sizes)), []).append(i)
        groups = []
        for size, idxs in sorted(by_bucket.items()):
            groups += [(size, idxs)] if chunk is None else [(size, [i]) for i in idxs]
        out: List[Optional[np.ndarray]] = [None] * len(images_rgb)
        for size, idxs in groups:
            lbs, metas = [], []
            for i in idxs:
                lb, gain, pad = letterbox(images_rgb[i], size)
                lbs.append(np.ascontiguousarray(lb, dtype=np.float32))
                metas.append((gain, pad, images_rgb[i].shape[:2]))
            fn = self._fn(size)
            dev = next(iter(fn.state_dict().values())).device
            with torch.no_grad():
                dets, num = fn(torch.from_numpy(np.stack(lbs)).to(dev))
            for i, d in zip(idxs, postprocess_to_original(dets, num, metas, decode=decode, conf_thresh=conf,
                                                          apply_conf_filter=apply_conf_filter)):
                out[i] = d
        return out
