"""YOLOv10 dual-assignment detection loss.

Counterpart of the JAX package's `leanyolo_tpu/models/yolov10/losses.py`
(reference `leanyolo/models/yolov10/losses.py:11-190`): BCE classification
normalized by the summed target scores, CIoU + DFL regression on the
positives (lambda cls/iou/dfl = 1/1/1.5), for the one2many branch with TAL
top-k 10 and the one2one branch with top-k 1, summed. Targets arrive padded
to a fixed [B, Nmax] (`build_padded_targets`). The loss runs in fp32; the
trainer upcasts the head maps level by level.

Data parallel (`group`): each process holds its rows of the global batch, and
the normalizer is the global batch's summed target scores, all-reduced before
the clamp (JAX's sum under its mesh); a process's loss is its rows' share of
the global loss, and the shares sum to it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ...ops.anchors import bbox2dist, dfl_expectation, dist2bbox, make_anchors
from ...ops.boxes import box_ciou_paired
from ...ops.tal import task_aligned_assign

Tensor = torch.Tensor


def dfl_loss(logits: Tensor, target: Tensor, reg_max: int) -> Tensor:
    """Distribution focal loss per item and side: [..., 4 * reg_max] logits,
    [..., 4] fractional bin targets -> [..., 4] (the caller masks and sums).

    Two-bin interpolated NLL; the target is clipped to reg_max - 1 - 1e-3 and
    the bin weights are constants of the gradient (JAX `losses.py:29-51`).
    """
    x = logits.reshape(logits.shape[:-1] + (4, reg_max))
    t = torch.clamp(target, 0.0, reg_max - 1 - 1e-3).detach()
    lo = torch.floor(t)
    wl, wu = lo + 1 - t, t - lo
    logp = torch.log_softmax(x, dim=-1)
    bins = torch.arange(reg_max, dtype=t.dtype, device=t.device)
    w = wl[..., None] * (bins == lo[..., None]) + wu[..., None] * (bins == lo[..., None] + 1)
    return -(logp * w).sum(dim=-1)


def _bce_with_logits(logits: Tensor, targets: Tensor) -> Tensor:
    """Elementwise binary cross-entropy with logits, JAX's formula."""
    return torch.clamp_min(logits, 0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _branch_loss(
    feats: Sequence,
    gt_labels: Tensor,
    gt_bboxes: Tensor,
    mask_gt: Tensor,
    *,
    num_classes: int,
    reg_max: int,
    strides: Tuple[int, ...],
    tal_topk: int,
    lambda_cls: float = 1.0,
    lambda_iou: float = 1.0,
    lambda_dfl: float = 1.5,
    group=None,
) -> Dict[str, Tensor]:
    """One head branch's loss over per-level (reg, cls) NHWC maps, or
    concatenated NHWC maps [B, H, W, 4*reg_max + nc]."""
    if isinstance(feats[0], (tuple, list)):
        b = feats[0][0].shape[0]
        hw_shapes = [(r.shape[1], r.shape[2]) for r, _ in feats]
        pred_distri = torch.cat([r.reshape(b, -1, 4 * reg_max) for r, _ in feats], dim=1)
        pred_scores = torch.cat([c.reshape(b, -1, num_classes) for _, c in feats], dim=1)
    else:
        b = feats[0].shape[0]
        hw_shapes = [(f.shape[1], f.shape[2]) for f in feats]
        flat = torch.cat([f.reshape(b, -1, 4 * reg_max + num_classes) for f in feats], dim=1)
        pred_distri, pred_scores = flat[..., : 4 * reg_max], flat[..., 4 * reg_max :]

    anchor_xy, stride_t = make_anchors(hw_shapes, strides, device=pred_distri.device)  # [A, 2], [A, 1]
    pred_bboxes = dist2bbox(dfl_expectation(pred_distri, reg_max), anchor_xy[None])  # feature space

    assign = task_aligned_assign(
        pred_scores.detach(),
        pred_bboxes.detach() * stride_t[None],
        anchor_xy * stride_t,
        gt_labels,
        gt_bboxes,
        mask_gt,
        topk=tal_topk,
        num_classes=num_classes,
    )

    total_scores = assign.target_scores.sum()
    if group is not None:
        dist.all_reduce(total_scores, group=group)
    denom = torch.clamp_min(total_scores, 1.0)
    cls_loss = _bce_with_logits(pred_scores, assign.target_scores).sum() / denom

    fg = assign.fg_mask.to(pred_distri.dtype)
    tgt_feat = assign.target_bboxes / stride_t[None]  # back to feature space
    iou_term = ((1.0 - box_ciou_paired(pred_bboxes, tgt_feat)) * fg).sum() / denom

    t_ltrb = bbox2dist(anchor_xy[None], tgt_feat, reg_max - 1)
    dfl_term = (dfl_loss(pred_distri, t_ltrb, reg_max) * fg[..., None]).sum() / denom

    reg_loss = lambda_iou * iou_term + lambda_dfl * dfl_term
    return {"total": lambda_cls * cls_loss + reg_loss, "cls": cls_loss, "reg": reg_loss}


def detection_loss_v10(
    raw,
    gt_labels: Tensor,
    gt_bboxes: Tensor,
    mask_gt: Tensor,
    *,
    num_classes: int,
    reg_max: int = 16,
    strides: Tuple[int, ...] = (8, 16, 32),
    group=None,
) -> Dict[str, Tensor]:
    """YOLOv10 loss: one2many (TAL top-k 10) + one2one (top-k 1).

    raw: {'one2many': [P3, P4, P5], 'one2one': [...]} NHWC maps (or per-level
    (reg, cls) tuples), or a plain list for a one2many-only loss.
    gt_labels [B, Nmax] int, gt_bboxes [B, Nmax, 4] xyxy input pixels,
    mask_gt [B, Nmax] bool. group: a torch.distributed group whose
    processes hold the rest of the global batch (None: this batch alone).
    """
    kw = dict(num_classes=num_classes, reg_max=reg_max, strides=strides, group=group)
    if isinstance(raw, dict):
        l_many = _branch_loss(raw["one2many"], gt_labels, gt_bboxes, mask_gt, tal_topk=10, **kw)
        l_one = _branch_loss(raw["one2one"], gt_labels, gt_bboxes, mask_gt, tal_topk=1, **kw)
        return {k: l_many[k] + l_one[k] for k in ("total", "cls", "reg")}
    return _branch_loss(raw, gt_labels, gt_bboxes, mask_gt, tal_topk=10, **kw)


def build_padded_targets(targets: List[dict], max_boxes: int):
    """Host side: [{'boxes': [Ni, 4], 'labels': [Ni]}, ...] -> numpy
    (gt_labels [B, max_boxes] int32, gt_bboxes [B, max_boxes, 4] fp32,
    mask_gt [B, max_boxes] bool), truncating at max_boxes."""
    bsz = len(targets)
    gt_labels = np.zeros((bsz, max_boxes), np.int32)
    gt_bboxes = np.zeros((bsz, max_boxes, 4), np.float32)
    mask_gt = np.zeros((bsz, max_boxes), bool)
    for i, t in enumerate(targets):
        n = min(int(np.asarray(t["boxes"]).shape[0]), max_boxes)
        if n:
            gt_bboxes[i, :n] = np.asarray(t["boxes"], np.float32)[:n]
            gt_labels[i, :n] = np.asarray(t["labels"], np.int32)[:n]
            mask_gt[i, :n] = True
    return gt_labels, gt_bboxes, mask_gt
