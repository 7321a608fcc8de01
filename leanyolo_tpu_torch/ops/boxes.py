"""Box geometry for the training loss and the assignment.

Counterparts of the JAX package's `leanyolo_tpu/ops/boxes.py:32-118`, with
the same eps placement (reference `leanyolo/utils/tal.py:55-86`). In both
CIoU forms `alpha` is a constant of the gradient (detached), as JAX's
`stop_gradient` makes it.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def box_area(boxes: Tensor) -> Tensor:
    wh = torch.clamp_min(boxes[..., 2:4] - boxes[..., 0:2], 0.0)
    return wh[..., 0] * wh[..., 1]


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU matrix. boxes1 [N, 4], boxes2 [M, 4] -> [N, M] (xyxy)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:4], boxes2[None, :, 2:4])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / (union + 1e-9)


def _aspect_term(b1: Tensor, b2: Tensor, iou: Tensor) -> Tensor:
    """alpha * v of CIoU, with alpha detached."""
    w1 = torch.clamp_min(b1[..., 2] - b1[..., 0], 1e-9)
    h1 = torch.clamp_min(b1[..., 3] - b1[..., 1], 1e-9)
    w2 = torch.clamp_min(b2[..., 2] - b2[..., 0], 1e-9)
    h2 = torch.clamp_min(b2[..., 3] - b2[..., 1], 1e-9)
    v = (4 / (math.pi ** 2)) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (1 - iou + v + 1e-9)).detach()
    return alpha * v


def _iou_c2(b1: Tensor, b2: Tensor):
    """(iou, squared diagonal of the enclosing box + 1e-9) of broadcast pairs."""
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    area1 = torch.clamp_min(b1[..., 2] - b1[..., 0], 0.0) * torch.clamp_min(b1[..., 3] - b1[..., 1], 0.0)
    area2 = torch.clamp_min(b2[..., 2] - b2[..., 0], 0.0) * torch.clamp_min(b2[..., 3] - b2[..., 1], 0.0)
    union = area1 + area2 - inter + 1e-9
    iou = inter / union
    cw = torch.clamp_min(torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0]), 0.0)
    ch = torch.clamp_min(torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1]), 0.0)
    return iou, cw ** 2 + ch ** 2 + 1e-9


def box_ciou_pairwise(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Complete IoU matrix between boxes1 [..., N, 4] and boxes2 [..., M, 4]
    (xyxy) -> [..., N, M], clipped to [0, 1] (JAX `box_ciou_pairwise`; the
    leading dims take the place of its vmap over the batch)."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    iou, c2 = _iou_c2(b1, b2)
    b1cx = (b1[..., 0] + b1[..., 2]) / 2
    b1cy = (b1[..., 1] + b1[..., 3]) / 2
    b2cx = (b2[..., 0] + b2[..., 2]) / 2
    b2cy = (b2[..., 1] + b2[..., 3]) / 2
    rho2 = (b1cx - b2cx) ** 2 + (b1cy - b2cy) ** 2
    return torch.clamp(iou - (rho2 / c2) - _aspect_term(b1, b2, iou), 0.0, 1.0)


def box_ciou_paired(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Elementwise CIoU of matched pairs: [..., 4] x [..., 4] -> [...]
    (JAX `box_ciou_paired`; the centre distance is formed as it forms it)."""
    b1, b2 = boxes1, boxes2
    iou, c2 = _iou_c2(b1, b2)
    rho2 = ((b1[..., 0] + b1[..., 2] - b2[..., 0] - b2[..., 2]) / 2) ** 2 + (
        (b1[..., 1] + b1[..., 3] - b2[..., 1] - b2[..., 3]) / 2
    ) ** 2
    return torch.clamp(iou - (rho2 / c2) - _aspect_term(b1, b2, iou), 0.0, 1.0)
