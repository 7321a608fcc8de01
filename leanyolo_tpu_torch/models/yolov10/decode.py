"""NMS-free two-stage top-k decode of the one2one branch.

Counterpart of the JAX package's `leanyolo_tpu/models/yolov10/decode.py:78-202`
(`decode_topk`, `_split_levels`, `_boxes_per_level`); the NMS decode
belongs to a later slice. Ranking runs on logits (the sigmoid is
monotonic), per level, in the maps' dtype: stage 1 ranks the per-anchor
class max, stage 2 the (anchor, class) pairs of the survivors. The level
gather is a direct index gather. DFL and the box decode run in fp32 on the
upcast reg logits.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ...ops.anchors import dfl_expectation, dist2bbox, make_anchors
from ...ops.topk import topk_lastdim

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
