"""Decode paths: the NMS-free two-stage top-k and the masked greedy NMS.

Counterpart of the JAX package's `leanyolo_tpu/models/yolov10/decode.py`
(`approx=True`, `lax.approx_max_k`, is out of the port's scope):

- `decode_topk` (one2one branch): ranking runs on logits (the sigmoid is
  monotonic), per level, in the maps' dtype: stage 1 ranks the per-anchor
  class max, stage 2 the (anchor, class) pairs of the survivors;
- `decode_nms` (one2many branch): candidates are the best class of each
  anchor (the fused max/argmax kernel, one launch for all levels) or, with
  `multi_label`, the top (anchor, class) pairs; the top `pre_topk` by logit
  go to the NMS kernel, which masks by confidence, runs greedy NMS
  (class-wise by the JAX decode's offset trick) and compacts the survivors
  into `(dets [B, max_det, 6], num [B])`;
- `decode_direct_nms`: the legacy direct-offset head layout, then the same
  NMS, in the maps' dtype as JAX runs it: on bf16 maps every step rounds
  to bf16 and the NMS kernel runs its bf16 mode.

The level gather is a direct index gather. DFL and the box decode run in
fp32 on the upcast reg logits. `detections_to_list` and
`postprocess_to_original` are the host side, in numpy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...kernels import nms as _knms
from ...ops.anchors import dfl_expectation, dist2bbox, make_anchors
from ...ops.topk import max_argmax_lastdim, topk_lastdim

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


def _flatten_levels(preds: Sequence, num_classes: int, strides: Sequence[int]):
    """Concat levels -> (flat [B, A, 4R+nc], anchors [A, 2], stride [A, 1], reg_max)."""
    assert len(preds) == len(strides)
    levels, hw_shapes, reg_max = _split_levels(list(preds), num_classes)
    anchors, stride_t = make_anchors(hw_shapes, strides, device=levels[0][0].device)
    flat = torch.cat([torch.cat([reg, cls], dim=-1) for reg, cls in levels], dim=1)
    return flat, anchors, stride_t, reg_max


def _flatten_pyramid(preds: Sequence, num_classes: int, strides: Sequence[int]):
    """Dense decode: (boxes [B, A, 4] pixels, cls logits [B, A, nc])."""
    flat, anchors, stride_t, reg_max = _flatten_levels(list(preds), num_classes, strides)
    dist = dfl_expectation(flat[..., : 4 * reg_max].float(), reg_max)
    return dist2bbox(dist, anchors[None]) * stride_t[None], flat[..., 4 * reg_max:]


def _gather_levels(level_arrays: Sequence[Tensor], idx: Tensor) -> Tensor:
    """Rows by global anchor index [B, k] from per-level [B, HW_l, C] arrays."""
    out = None
    off = 0
    for lv in level_arrays:
        hw = lv.shape[1]
        local = idx - off
        inside = (local >= 0) & (local < hw)
        g = torch.gather(lv, 1, local.clamp(0, hw - 1).long()[..., None].expand(-1, -1, lv.shape[-1]))
        out = g if out is None else torch.where(inside[..., None], g, out)
        off += hw
    return out


def _boxes_per_level(levels, hw_shapes, strides, reg_max) -> List[Tensor]:
    """Dense per-level DFL + box decode -> [B, HW_l, 4] xyxy pixel boxes."""
    out = []
    for (reg, _), (h, w), s in zip(levels, hw_shapes, strides):
        anchors_l, _ = make_anchors([(h, w)], [s], device=reg.device)
        dist_l = dfl_expectation(reg.float(), reg_max)
        out.append(dist2bbox(dist_l, anchors_l[None]) * float(s))
    return out


def decode_topk(preds: Sequence, *, num_classes: int, strides: Sequence[int] = (8, 16, 32),
                max_det: int = 300) -> Tensor:
    """[B, k, 6] = [x1, y1, x2, y2, score, cls], k = min(max_det, anchors)."""
    levels, hw_shapes, reg_max = _split_levels(list(preds), num_classes)
    b = levels[0][0].shape[0]
    k = min(max_det, sum(h * w for h, w in hw_shapes))
    nc = num_classes

    max_per_anchor = torch.cat([cls.amax(dim=-1) for _, cls in levels], dim=1)  # [B, A]
    _, top_anchor_idx = topk_lastdim(max_per_anchor, k)  # [B, k]
    sel_logits = _gather_levels([cls for _, cls in levels], top_anchor_idx)  # [B, k, nc]

    flat_logits, flat_idx = topk_lastdim(sel_logits.reshape(b, -1), k)  # [B, k]
    scores = torch.sigmoid(flat_logits.float())
    rel_anchor = torch.div(flat_idx, nc, rounding_mode="floor")
    cls_idx = (flat_idx % nc).float()
    final_anchor_idx = torch.gather(top_anchor_idx, 1, rel_anchor.long())

    final_boxes = _gather_levels(_boxes_per_level(levels, hw_shapes, strides, reg_max), final_anchor_idx)
    return torch.cat([final_boxes, scores[..., None], cls_idx[..., None]], dim=-1)


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
    levels, hw_shapes, reg_max = _split_levels(list(preds), num_classes)
    b = levels[0][0].shape[0]
    a = sum(h * w for h, w in hw_shapes)
    nc = num_classes
    if multi_label:
        k_pre = min(pre_topk, a * nc)
        merged_logits, merged_pair = [], []
        off = 0
        for _, cls in levels:
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
        best_logits, best_cls = max_argmax_lastdim([cls for _, cls in levels], dtype=rank_dtype)
        k_pre = min(pre_topk, a)
        cand_logits, anc_idx = topk_lastdim(best_logits, k_pre)
        cand_cls = torch.gather(best_cls, 1, anc_idx.long()).float()
    cand_scores = torch.sigmoid(cand_logits.float())
    cand_boxes = _gather_levels(_boxes_per_level(levels, hw_shapes, strides, reg_max), anc_idx)
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
