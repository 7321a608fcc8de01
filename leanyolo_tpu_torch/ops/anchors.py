"""Anchor-free grid math for the YOLOv10 heads.

Counterpart of the JAX package's `leanyolo_tpu/ops/anchors.py:17-91`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(
    hw_shapes: Sequence[Tuple[int, int]], strides: Sequence[int], device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 anchor centres [A, 2] (x, y in cell units, levels concatenated)
    and per-anchor strides [A, 1]; centres sit at cell centre +0.5."""
    assert len(hw_shapes) == len(strides)
    points, stride_vals = [], []
    for (h, w), s in zip(hw_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + 0.5
        sy = torch.arange(h, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack((gx, gy), dim=-1).reshape(-1, 2))
        stride_vals.append(torch.full((h * w, 1), float(s), dtype=torch.float32, device=device))
    return torch.cat(points, dim=0), torch.cat(stride_vals, dim=0)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """Distances (l, t, r, b) -> xyxy boxes."""
    lt, rb = torch.chunk(distance, 2, dim=-1)
    return torch.cat((anchor_points - lt, anchor_points + rb), dim=-1)


def bbox2dist(anchor_points: torch.Tensor, bbox_xyxy: torch.Tensor, reg_max: int) -> torch.Tensor:
    """xyxy boxes -> distances (l, t, r, b) from the anchors, clipped to
    [0, reg_max - 0.01] (JAX `ops/anchors.py:63`)."""
    x1y1, x2y2 = torch.chunk(bbox_xyxy, 2, dim=-1)
    dist = torch.cat((anchor_points - x1y1, x2y2 - anchor_points), dim=-1)
    return torch.clamp(dist, 0.0, reg_max - 0.01)


def dfl_expectation(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """[..., 4 * reg_max] DFL logits (bins contiguous per side) -> [..., 4]
    expected (l, t, r, b) distances in cell units (softmax over the bins, then
    the dot with 0..reg_max-1)."""
    probs = box_logits.reshape(box_logits.shape[:-1] + (4, reg_max))
    probs = torch.exp(probs - probs.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    bins = torch.arange(reg_max, dtype=probs.dtype, device=probs.device)
    return probs @ bins
