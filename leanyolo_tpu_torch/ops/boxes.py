"""Box geometry, fixed-shape greedy NMS and the letterbox inverse.

Counterparts of the JAX package's `leanyolo_tpu/ops/boxes.py`, with the
same eps placement (reference `leanyolo/utils/tal.py:55-86`). In both CIoU
forms `alpha` is a constant of the gradient (detached), as JAX's
`stop_gradient` makes it.

`nms_fixed` takes one image's candidates, as JAX's does, and picks the
schedule as JAX does: `_alive_blocked` for presorted input and the blocked
schedule, `_alive_jacobi` for "jacobi". On a card `_alive_blocked` is the
NMS kernel's keep mode (kernels/nms.py), which walks the ranks in order
and takes no block; on the CPU it is JAX's blocked substitution in plain
PyTorch, block by block. `_alive_jacobi` is plain PyTorch. All give the
exact greedy keep set, so `schedule` and `block` change how it is
computed, never what. bf16 boxes take the bf16 arithmetic, as in JAX: each
IoU operation rounded to bf16 and the threshold rounded to bf16 (the
kernel's bf16 mode on a card). The decode does not come through here: its NMS
(`_nms_single`) calls the kernel's compacting mode directly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels import nms as _knms

Tensor = torch.Tensor


def box_xywh_to_xyxy(boxes: Tensor) -> Tensor:
    x, y, w, h = boxes.split(1, dim=-1)
    return torch.cat((x - w / 2, y - h / 2, x + w / 2, y + h / 2), dim=-1)


def box_xyxy_to_xywh(boxes: Tensor) -> Tensor:
    x1, y1, x2, y2 = boxes.split(1, dim=-1)
    w = torch.clamp_min(x2 - x1, 0.0)
    h = torch.clamp_min(y2 - y1, 0.0)
    return torch.cat((x1 + w / 2, y1 + h / 2, w, h), dim=-1)


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
    eps = _knms.rounded(1e-9, torch.bfloat16) if boxes1.dtype == torch.bfloat16 else 1e-9
    return inter / (union + eps)


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


def _alive_jacobi(boxes_s: Tensor, iou_thresh: float) -> Tensor:
    """Greedy-NMS survivors over score-sorted boxes [n, 4] by Jacobi sweeps
    of alive[i] = not OR_{j<i}(supp[j, i] and alive[j]) to the fixed point
    (JAX `_alive_jacobi`; counts of 0/1 values are exact in fp32)."""
    n = boxes_s.shape[0]
    rank = torch.arange(n, device=boxes_s.device)
    supp = ((box_iou(boxes_s, boxes_s) > _knms.rounded(iou_thresh, boxes_s.dtype))
            & (rank[:, None] < rank[None, :])).float()
    alive = torch.ones(n, dtype=torch.bool, device=boxes_s.device)
    for _ in range(n):
        new = (alive.float() @ supp) == 0.0
        if torch.equal(new, alive):
            break
        alive = new
    return alive


def _alive_blocked(boxes_s: Tensor, iou_thresh: float, block: int, valid: Optional[Tensor] = None) -> Tensor:
    """Greedy-NMS survivors over score-sorted boxes [n, 4] (JAX
    `_alive_blocked`). `valid` [n] bool: False entries never survive or
    suppress. On a card: the NMS kernel. On the CPU: blocked forward
    substitution, per block of `block` ranks its IoU rows against every
    candidate, the exact greedy solve inside the block by Jacobi sweeps,
    and its survivors' kill counts added to the later ranks."""
    dtype = _knms.arithmetic_dtype(boxes_s)
    if boxes_s.device.type != "cpu":
        return _knms.nms_keep(boxes_s.to(dtype).contiguous()[None], iou_thresh,
                              None if valid is None else valid[None])[0]
    n = boxes_s.shape[0]
    nb = -(-n // block)
    n_pad = nb * block
    thr = _knms.rounded(iou_thresh, dtype)
    if n_pad > n:  # zero-area padding: IoU 0 against everything
        boxes_s = torch.cat([boxes_s, boxes_s.new_zeros(n_pad - n, 4)])
    if valid is not None and n_pad > n:
        valid = torch.cat([valid, valid.new_zeros(n_pad - n)])
    rank = torch.arange(block, device=boxes_s.device)
    tri = rank[:, None] < rank[None, :]
    gidx = torch.arange(n_pad, device=boxes_s.device)
    acc = torch.zeros(n_pad, device=boxes_s.device)
    alive = torch.zeros(n_pad, dtype=torch.bool, device=boxes_s.device)
    for k in range(nb):
        start = k * block
        supp_blk = (box_iou(boxes_s[start:start + block], boxes_s) > thr).float()  # [m, n_pad]
        intra = torch.where(tri, supp_blk[:, start:start + block], 0.0)
        live0 = acc[start:start + block] == 0.0
        if valid is not None:
            live0 = live0 & valid[start:start + block]
        a = live0
        for _ in range(block):
            new = live0 & ((a.float() @ intra) == 0.0)
            if torch.equal(new, a):
                break
            a = new
        acc = acc + torch.where(gidx >= start + block, a.float() @ supp_blk, 0.0)
        alive[start:start + block] = a
    return alive[:n]


def _descending_order(scores: Tensor) -> Tensor:
    """argsort(-scores), stable, in lax.sort's total order of floats
    (-0.0 below +0.0, NaNs at the ends by sign), as `jnp.argsort` orders."""
    bits = (-scores).float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits + 0x80000000)
    return torch.argsort(key, stable=True)


def nms_fixed(boxes: Tensor, scores: Tensor, iou_thresh: float, *, schedule: str = "blocked", block: int = 64,
              presorted: bool = False, valid: Optional[Tensor] = None) -> Tensor:
    """Greedy NMS over one image's fixed-size candidate set -> keep [N] bool
    aligned with the input order (JAX `nms_fixed`).

    boxes [N, 4] xyxy, scores [N]; a box is removed when a kept box of
    higher rank overlaps it with IoU > iou_thresh. presorted: the input is
    already in descending-score order (scores unused). valid [N] bool:
    False entries neither survive nor suppress. schedule "blocked" (and any
    presorted input) runs `_alive_blocked` with `block` ranks a block;
    "jacobi" the global fixed-point sweeps.
    """
    if schedule not in ("blocked", "jacobi"):
        raise ValueError(f"unknown NMS schedule {schedule!r}")
    if block < 1:
        raise ValueError("block must be positive")
    block = max(1, min(block, boxes.shape[0]))
    if presorted:
        return _alive_blocked(boxes, iou_thresh, block, valid)
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = _descending_order(scores)
    boxes_s = boxes[order]
    if schedule == "jacobi":
        alive = _alive_jacobi(boxes_s, iou_thresh)
    else:
        alive = _alive_blocked(boxes_s, iou_thresh, block)
    keep = torch.zeros(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    keep[order] = alive
    if valid is not None:
        keep = keep & valid  # invalid entries rank last: they suppress no valid one
    return keep


def scale_coords(from_shape: Tuple[int, int], boxes: Tensor, to_shape: Tuple[int, int]) -> Tensor:
    """Scale xyxy boxes from from_shape (h, w) to to_shape (h, w)."""
    fh, fw = from_shape
    th, tw = to_shape
    gain = torch.tensor([tw / max(fw, 1), th / max(fh, 1), tw / max(fw, 1), th / max(fh, 1)], dtype=boxes.dtype,
                        device=boxes.device)
    return boxes * gain


def unletterbox_coords(boxes: Tensor, gain: Tuple[float, float], pad: Tuple[int, int],
                       to_shape: Tuple[int, int]) -> Tensor:
    """Invert letterboxing for xyxy boxes; clips to the original image."""
    gw, gh = gain
    px, py = pad
    h, w = to_shape
    x1 = torch.clamp((boxes[..., 0] - px) / gw, 0, w)
    y1 = torch.clamp((boxes[..., 1] - py) / gh, 0, h)
    x2 = torch.clamp((boxes[..., 2] - px) / gw, 0, w)
    y2 = torch.clamp((boxes[..., 3] - py) / gh, 0, h)
    return torch.stack((x1, y1, x2, y2), dim=-1)
