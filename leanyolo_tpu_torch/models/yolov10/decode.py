"""Decode paths: the NMS-free two-stage top-k and the masked greedy NMS.

Counterpart of the JAX package's `leanyolo_tpu/models/yolov10/decode.py`
(`approx=True`, `lax.approx_max_k`, is out of the port's scope):

- `decode_topk` (one2one branch): ranking runs on logits (the sigmoid is
  monotonic), in the maps' dtype: stage 1 ranks the per-anchor class max
  (the fused max/argmax kernel over the three levels, `jnp.max`'s zero
  rule: -0.0 below +0.0, NaN propagated), stage 2 (the fused second top-k,
  `kernels/topk.py::topk_decode`) the (anchor, class) pairs of the
  survivors, whose class rows it reads as JAX's one-hot dot gathers them,
  and writes the detections of the winners, boxes decoded from their reg
  bins: three launches (max/argmax, top-k, fused top-k);
- `decode_nms` (one2many branch): candidates are the best class of each
  anchor (the fused max/argmax kernel, one launch for all levels) or, with
  `multi_label`, the top (anchor, class) pairs; the top `pre_topk` by logit,
  with their boxes from the box decode kernel (those anchors only), go to
  the NMS kernel, which masks by confidence, runs greedy NMS
  (class-wise by the JAX decode's offset trick) and compacts the survivors
  into `(dets [B, max_det, 6], num [B])`;
- `decode_direct_nms`: the legacy direct-offset head layout, then the same
  NMS, in the maps' dtype as JAX runs it: on bf16 maps every step rounds
  to bf16 and the NMS kernel runs its bf16 mode.

The DFL and the box decode run in fp32 on the selected anchors' reg logits
only (kernels/dfl.py), never densely, also in the serving export.

JAX gathers the selected rows and boxes by one-hot dots, so a non-finite
value anywhere in an image's maps spreads (0 * inf = NaN): the max/argmax
launch also writes per-image flags of the maps' non-finite values
(kernels/argmax.py), from which the gather and the box decode write the
same NaNs. `detections_to_list` and `postprocess_to_original` are the host
side, in numpy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...kernels import argmax as _kargmax
from ...kernels import dfl as _kdfl
from ...kernels import nms as _knms
from ...kernels import topk as _ktopk
from ...ops.topk import _rank_dtype, canon_zero, max_argmax_lastdim, topk_lastdim

Tensor = torch.Tensor


def _split_levels(preds: Sequence, num_classes: int):
    """Per-level (box_logits [B,HW,4R], cls_logits [B,HW,nc]), (h, w) shapes, reg_max.

    Takes concatenated [B, H, W, 4R+nc] maps or (reg, cls) NHWC tuples.
    """
    levels, hw_shapes = [], []
    for p in preds:
        if isinstance(p, (tuple, list)):
            reg, cls = p
            b, h, w = reg.shape[:3]
            assert cls.shape[-1] == num_classes
            levels.append((reg.reshape(b, h * w, reg.shape[-1]), cls.reshape(b, h * w, num_classes)))
        else:
            b, h, w, ct = p.shape
            flat = p.reshape(b, h * w, ct)
            levels.append((flat[..., : ct - num_classes], flat[..., ct - num_classes :]))
        hw_shapes.append((h, w))
    reg_max = levels[0][0].shape[-1] // 4
    assert levels[0][0].shape[-1] == 4 * reg_max
    return levels, hw_shapes, reg_max


def decode_topk(preds: Sequence, *, num_classes: int, strides: Sequence[int] = (8, 16, 32),
                max_det: int = 300) -> Tensor:
    """[B, k, 6] = [x1, y1, x2, y2, score, cls], k = min(max_det, anchors)."""
    levels, hw_shapes, _ = _split_levels(list(preds), num_classes)
    a = sum(h * w for h, w in hw_shapes)
    k = min(max_det, a)
    cls_levels, reg_levels = [cls for _, cls in levels], [reg for reg, _ in levels]
    dtype = cls_levels[0].dtype

    # Stage 1: jnp.max per anchor (fp32 values, exact for bf16), ranked as the
    # maps' dtype with JAX's tie rule for it; the same launch flags the maps'
    # non-finite values for stage 2's gathers.
    max_per_anchor, _, flags = _kargmax.max_argmax_flags(cls_levels, reg_levels, canon_zero=False)  # [B, A]
    _, top_anchor_idx = _ktopk.topk(max_per_anchor, k, canon_zero=canon_zero(dtype, k, a))  # [B, k]

    # Stage 2: the (anchor, class) pairs of the survivors, gathered as JAX's
    # one-hot dot gives them, ranked, and written as detections (boxes of
    # the final anchors only), in one launch.
    return _ktopk.topk_decode(cls_levels, reg_levels, hw_shapes, strides, top_anchor_idx, k,
                              canon_zero=canon_zero(dtype, k, k * num_classes), flags=flags)


GROUP_OFFSET = _knms.GROUP_OFFSET  # class offset of the class-wise NMS (JAX decode.py:341)


def _nms_single(boxes: Tensor, scores: Tensor, cls_idx: Tensor, *, iou_thresh: float, conf_thresh: float,
                max_det: int, class_wise: bool, group_offset: float = GROUP_OFFSET) -> Tuple[Tensor, Tensor]:
    """Greedy NMS on fixed-size candidate sets in descending-score order,
    boxes [..., K, 4], scores and cls_idx [..., K] -> (dets [..., max_det,
    6], num [...] int32): valid = score > conf_thresh; row j is the j-th
    survivor while j < min(max_det, K), zero rows follow (JAX
    `_nms_single`, whose vmap is the leading dims here). Runs in the NMS
    kernel's wrapper, in bf16 arithmetic where the boxes are bf16 (the
    rest is then cast to bf16, as JAX's concatenation promotes it), else
    in fp32."""
    lead = boxes.shape[:-2]
    k = boxes.shape[-2]
    dt = _knms.arithmetic_dtype(boxes)
    dets, num = _knms.nms_compact(boxes.reshape(-1, k, 4).to(dt).contiguous(),
                                  scores.reshape(-1, k).to(dt).contiguous(),
                                  cls_idx.reshape(-1, k).to(dt).contiguous(), iou_thresh=iou_thresh,
                                  conf_thresh=conf_thresh, max_det=max_det, class_wise=class_wise,
                                  group_offset=group_offset)
    return dets.reshape(lead + (max_det, 6)), num.reshape(lead)


def decode_nms(preds: Sequence, *, num_classes: int, strides: Sequence[int] = (8, 16, 32),
               conf_thresh: float = 0.25, iou_thresh: float = 0.45, max_det: int = 300, pre_topk: int = 1000,
               class_wise: bool = False, multi_label: bool = False,
               rank_dtype: Optional[torch.dtype] = None) -> Tuple[Tensor, Tensor]:
    """Confidence filter + greedy NMS with a fixed-shape contract (JAX
    `decode_nms`) -> (dets [B, max_det, 6] fp32, invalid rows zero; num [B]
    int32, valid rows first).

    multi_label: candidates are the top (anchor, class) pairs (the export
    wrapper's semantics); else one candidate per anchor at its best class.
    rank_dtype: rank the class logits as if cast to it (None: the maps'
    dtype, as JAX's benchmark ranks bf16 maps; float32 on bf16 maps: as
    JAX's predictor ranks its upcast maps, without writing them, since the
    upcast is exact).
    """
    levels, hw_shapes, _ = _split_levels(list(preds), num_classes)
    b = levels[0][0].shape[0]
    a = sum(h * w for h, w in hw_shapes)
    nc = num_classes
    cls_levels, reg_levels = [cls for _, cls in levels], [reg for reg, _ in levels]
    dtype = _rank_dtype(cls_levels[0].dtype, rank_dtype)
    # The best class per anchor, and the flags of the maps' non-finite values
    # (JAX's one-hot-dot gather of the boxes spreads a NaN side), in one
    # launch; multi_label takes the flags alone.
    best_logits, best_cls, flags = _kargmax.max_argmax_flags(cls_levels, reg_levels,
                                                             canon_zero=_kargmax.packed_route(dtype, nc))
    if multi_label:
        k_pre = min(pre_topk, a * nc)
        merged_logits, merged_pair = [], []
        off = 0
        for cls in cls_levels:
            hw = cls.shape[1]
            v, p = topk_lastdim(cls.reshape(b, hw * nc), min(k_pre, hw * nc), dtype=rank_dtype)
            merged_logits.append(v)
            merged_pair.append((p // nc + off) * nc + p % nc)  # global pair index
            off += hw
        cand_logits, pos = topk_lastdim(torch.cat(merged_logits, dim=1), k_pre)
        pre_idx = torch.gather(torch.cat(merged_pair, dim=1), 1, pos.long())
        anc_idx = pre_idx // nc
        cand_cls = (pre_idx % nc).float()
    else:
        k_pre = min(pre_topk, a)
        cand_logits, anc_idx = topk_lastdim(best_logits.to(dtype), k_pre)
        cand_cls = torch.gather(best_cls, 1, anc_idx.long()).float()
    cand_scores = torch.sigmoid(cand_logits.float())
    cand_boxes = _kdfl.dfl_boxes(reg_levels, hw_shapes, strides, anc_idx, flags=flags)
    return _nms_single(cand_boxes, cand_scores, cand_cls, iou_thresh=iou_thresh, conf_thresh=conf_thresh,
                       max_det=max_det, class_wise=class_wise)


def _ftz(x: Tensor) -> Tensor:
    """Subnormal results to +0, as XLA's CPU arithmetic flushes them."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, torch.zeros_like(x), x)


def _exp(x: Tensor) -> Tensor:
    """`jnp.exp` in the maps' dtype (bf16: subnormals flushed, as XLA's)."""
    return torch.exp(x) if x.dtype != torch.bfloat16 else _ftz(torch.exp(x))


def _sigmoid(x: Tensor) -> Tensor:
    """`jax.nn.sigmoid` in the maps' dtype: fp32 as torch computes it (up to
    3 ulp from XLA's below a logit of 6.4, equal above, where the scores
    saturate); bf16 as XLA expands it, 1 / (1 + exp(-x)) with each
    operation rounded to bf16 and subnormals flushed (bit-equal to JAX over
    every finite bf16 input)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return _ftz(1 / (1 + _exp(-x)))


def decode_direct_nms(preds: Sequence[Tensor], *, num_classes: int, strides: Sequence[int] = (8, 16, 32),
                      conf_thresh: float = 0.25, iou_thresh: float = 0.45, max_det: int = 300,
                      pre_topk: int = 1000) -> Tuple[Tensor, Tensor]:
    """Legacy direct-offset layout decode ([B, H, W, 4 + nc] per level; JAX
    `decode_direct_nms`): sigmoid centre offsets and exp width/height, the
    best class by the max and first argmax of the sigmoid scores (not the
    logits: saturated scores tie where logits do not), then the same NMS.
    Runs in the maps' dtype, fp32 or bf16, as JAX does: on bf16 maps the
    box arithmetic, sigmoid, max, argmax, top-k and classes are bf16 and
    the NMS kernel runs its bf16 mode; the dets are fp32 either way."""
    dtype = preds[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(p.dtype != dtype for p in preds):
        raise ValueError(f"decode_direct_nms takes float32 or bfloat16 maps of one dtype, got "
                         f"{[p.dtype for p in preds]}")
    b = preds[0].shape[0]
    boxes_l, scores_l = [], []
    for p, s in zip(preds, strides):
        _, h, w, c = p.shape
        assert c == 4 + num_classes
        flat = p.reshape(b, h * w, c)
        bbox = flat[..., :4]
        gy, gx = torch.meshgrid(torch.arange(h, dtype=p.dtype, device=p.device),
                                torch.arange(w, dtype=p.dtype, device=p.device), indexing="ij")
        gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)
        cx = (_sigmoid(bbox[..., 0]) + gx) * s
        cy = (_sigmoid(bbox[..., 1]) + gy) * s
        bw = _exp(bbox[..., 2]) * s
        bh = _exp(bbox[..., 3]) * s
        boxes_l.append(torch.stack((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2), dim=-1))
        scores_l.append(_sigmoid(flat[..., 4:]))
    boxes = torch.cat(boxes_l, dim=1)
    # jnp.max, jnp.argmax; bf16 scores hold no -0.0 (sigmoid), so the packed
    # route's zero rule is moot and its values are the maxima themselves.
    best_scores, best_cls = max_argmax_lastdim(scores_l)
    k_pre = min(pre_topk, boxes.shape[1])
    # lax.top_k; sigmoid scores hold no -0.0, so the route's zero rule is moot
    cand_scores, anc_idx = topk_lastdim(best_scores, k_pre)
    anc_idx = anc_idx.long()
    cand_cls = torch.gather(best_cls.to(dtype), 1, anc_idx)  # JAX: argmax.astype(boxes.dtype)
    cand_boxes = torch.gather(boxes, 1, anc_idx[..., None].expand(-1, -1, 4))
    return _nms_single(cand_boxes, cand_scores, cand_cls, iou_thresh=iou_thresh, conf_thresh=conf_thresh,
                       max_det=max_det, class_wise=False, group_offset=0.0)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def detections_to_list(dets, num_dets=None, conf_thresh: float = 0.0) -> List[np.ndarray]:
    """Host side: fixed [B, k, 6] -> a list of per-image numpy arrays [N_i, 6]
    (the first num_dets[i] rows, then those above conf_thresh where > 0)."""
    dets = _host(dets)
    num_dets = None if num_dets is None else _host(num_dets)  # one copy to the host
    out = []
    for i in range(dets.shape[0]):
        d = dets[i]
        if num_dets is not None:
            d = d[: int(num_dets[i])]
        if conf_thresh > 0:
            d = d[d[:, 4] > conf_thresh]
        out.append(d)
    return out


def postprocess_to_original(dets, num, metas, *, decode: str, conf_thresh: float,
                            apply_conf_filter: bool) -> List[np.ndarray]:
    """Host side: fixed-shape results -> per-image arrays in original-image
    coordinates. topk keeps the rows above conf_thresh (all rows without
    apply_conf_filter); nms the first num. `metas`: [(gain, pad, orig_hw)]
    from the letterbox (JAX `postprocess_to_original`, the same formulas as
    `ops/boxes.py::unletterbox_coords`, in numpy)."""
    selected = detections_to_list(
        dets,
        num_dets=None if decode == "topk" else num,
        conf_thresh=conf_thresh if (decode == "topk" and apply_conf_filter) else 0.0,
    )
    out = []
    for d, (gain, pad, orig_hw) in zip(selected, metas):
        if len(d):
            (gw, gh), (px, py), (h, w) = gain, pad, orig_hw
            bx = d[:, :4].astype(np.float32, copy=True)
            bx[:, 0::2] = ((bx[:, 0::2] - px) / gw).clip(0, w)
            bx[:, 1::2] = ((bx[:, 1::2] - py) / gh).clip(0, h)
            d = np.concatenate([bx, d[:, 4:6]], axis=1)
        out.append(d)
    return out
