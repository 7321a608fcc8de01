"""Plain float32 training step of the YOLOv10 reference: augmentation, the
dual-branch detection loss with its task-aligned assignment, the backward,
the per-group clip and AdamW.

Written for the benchmark after the published YOLOv10 loss (THU-MIG/yolov10
`ultralytics/utils/loss.py` v10DetectLoss, `tal.py` TaskAlignedAssigner) as
the system defines it, with these departures from the published code:

- the classification targets are the assigned class's one-hot on the
  foreground (not scaled by the normalized alignment), and the loss is
  normalized by their sum;
- an anchor claimed by several GTs goes to the GT of highest CIoU (not IoU);
- the one2one branch's assignment is top-1, the one2many's top-10, alpha
  0.5, beta 6, and the two branches' losses are summed with weights 1 / 1 /
  1.5 (cls / CIoU / DFL);
- a batch's GT slots are cut to the smallest of 8, 16, 32, 64, 128 that
  holds its fullest image.

Parameters form two groups, backbone + neck (learning rate x `bb_lr_mult`)
and head; each group is clipped by its own global norm (g * max / norm when
norm >= max), then AdamW (decoupled weight decay on every parameter).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from .model import dfl_boxes, flat_maps

Tensor = torch.Tensor
BUCKETS = (8, 16, 32, 64, 128)


def augment(images: Tensor, boxes: Tensor, u: Sequence[Tensor], p_hflip: float, p_bc: float) -> Tuple[Tensor, Tensor]:
    """Flip (u0 < p_hflip: the image mirrored left-right, its boxes with it)
    and brightness/contrast (u1 < p_bc: x * (0.8 + 0.4 u2) + 32 u3 - 16,
    clamped to [0, 255]), per image, in fp32."""
    w = images.shape[2]
    x = images.float()
    flip = (u[0] < p_hflip).to(images.device)
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    x1, y1, x2, y2 = boxes.unbind(-1)
    boxes = torch.where(flip[:, None, None], torch.stack([w - x2, y1, w - x1, y2], -1), boxes)
    bc = (u[1] < p_bc).to(images.device)
    alpha = (0.8 + 0.4 * u[2]).to(images.device)
    beta = (32.0 * u[3] - 16.0).to(images.device)
    jit = (x * alpha[:, None, None, None] + beta[:, None, None, None]).clamp(0.0, 255.0)
    return torch.where(bc[:, None, None, None], jit, x), boxes


def gt_bucket(mask: Tensor) -> int:
    need, slots = int(mask.sum(1).max()), mask.shape[1]
    return next((b for b in BUCKETS if need <= b <= slots), slots)


def _iou_c2(b1: Tensor, b2: Tensor) -> Tuple[Tensor, Tensor]:
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    a1 = (b1[..., 2] - b1[..., 0]).clamp_min(0) * (b1[..., 3] - b1[..., 1]).clamp_min(0)
    a2 = (b2[..., 2] - b2[..., 0]).clamp_min(0) * (b2[..., 3] - b2[..., 1]).clamp_min(0)
    iou = inter / (a1 + a2 - inter + 1e-9)
    cw = (torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])).clamp_min(0)
    ch = (torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])).clamp_min(0)
    return iou, cw ** 2 + ch ** 2 + 1e-9


def ciou(b1: Tensor, b2: Tensor) -> Tensor:
    """CIoU of broadcast xyxy pairs, clipped to [0, 1]; the aspect term's
    alpha is a constant of the gradient."""
    iou, c2 = _iou_c2(b1, b2)
    rho2 = ((b1[..., 0] + b1[..., 2] - b2[..., 0] - b2[..., 2]) / 2) ** 2 + \
           ((b1[..., 1] + b1[..., 3] - b2[..., 1] - b2[..., 3]) / 2) ** 2
    w1 = (b1[..., 2] - b1[..., 0]).clamp_min(1e-9)
    h1 = (b1[..., 3] - b1[..., 1]).clamp_min(1e-9)
    w2 = (b2[..., 2] - b2[..., 0]).clamp_min(1e-9)
    h2 = (b2[..., 3] - b2[..., 1]).clamp_min(1e-9)
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (1 - iou + v + 1e-9)).detach()
    return (iou - rho2 / c2 - alpha * v).clamp(0.0, 1.0)


@torch.no_grad()
def assign(logits: Tensor, boxes: Tensor, anchors: Tensor, labels: Tensor, gt: Tensor, mask: Tensor, topk: int,
           nc: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Task-aligned assignment -> (target boxes [B, A, 4], one-hot scores
    [B, A, nc], foreground [B, A]). Candidates: anchors whose centre lies
    strictly inside a valid GT; alignment sigmoid(logit of the GT's class)
    ** 0.5 * CIoU ** 6; each GT keeps its top-k anchors (first index on
    ties), or anchor 0 where its best alignment is <= 1e-9."""
    b, a, _ = logits.shape
    n = labels.shape[1]
    lt, rb = gt[..., None, :2], gt[..., None, 2:]
    inside = torch.cat((anchors[None, None] - lt, rb - anchors[None, None]), -1).amin(-1) > 1e-9
    inside = inside & mask[..., None]  # [B, N, A]
    overlaps = ciou(gt[:, :, None, :], boxes[:, None, :, :])  # [B, N, A]
    cls = labels.long().clamp_min(0)
    score = torch.gather(torch.sigmoid(logits), 2, cls[:, None, :].expand(b, a, n)).transpose(1, 2)
    align = score.clamp(0, 1) ** 0.5 * overlaps ** 6.0 * inside.float()
    has_any = align.amax(-1) > 1e-9
    k = min(topk, a)
    member = torch.ones_like(inside)
    if k < a:  # the k best, the first index winning a tie
        top = torch.sort(align, dim=-1, descending=True, stable=True).indices[..., :k]
        member = torch.zeros_like(inside).scatter_(2, top, True)
    anchor0 = (torch.arange(a, device=logits.device) == 0)[None, None]
    pos = torch.where(has_any[..., None], member, anchor0) & inside
    several = pos.sum(1, keepdim=True) > 1
    best = overlaps.argmax(1)[:, None, :] == torch.arange(n, device=logits.device)[None, :, None]
    pos = torch.where(several, best, pos)
    fg = pos.any(1)
    idx = pos.int().argmax(1)  # [B, A]
    tgt_boxes = torch.gather(gt, 1, idx[..., None].expand(b, a, 4))
    tgt_cls = torch.gather(cls, 1, idx)
    scores = ((tgt_cls[..., None] == torch.arange(nc, device=logits.device)) & fg[..., None]).float()
    return tgt_boxes, scores, fg


def _anchors(hw: Sequence[Tuple[int, int]], strides: Sequence[int], device) -> Tuple[Tensor, Tensor]:
    pts, st = [], []
    for (h, w), s in zip(hw, strides):
        gy, gx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32) + 0.5,
                                torch.arange(w, device=device, dtype=torch.float32) + 0.5, indexing="ij")
        pts.append(torch.stack((gx, gy), -1).reshape(-1, 2))
        st.append(torch.full((h * w, 1), float(s), device=device))
    return torch.cat(pts), torch.cat(st)


def branch_loss(levels, labels: Tensor, gt: Tensor, mask: Tensor, *, topk: int, nc: int, reg_max: int,
                strides: Sequence[int]) -> Tensor:
    """BCE over all (anchor, class) logits against the one-hot targets, plus
    (1 - CIoU) and 1.5 x the distribution focal loss on the foreground, each
    over the sum of the targets (at least 1)."""
    reg, cls, hw = flat_maps(levels)
    reg, cls = reg.float(), cls.float()
    pts, st = _anchors(hw, strides, reg.device)
    pred_px = dfl_boxes(reg, hw, strides, reg_max)  # pixels
    pred = pred_px / st  # feature units
    tgt_px, scores, fg = assign(cls.detach(), pred_px.detach(), pts * st, labels, gt, mask, topk, nc)
    denom = scores.sum().clamp_min(1.0)
    bce = cls.clamp_min(0) - cls * scores + torch.log1p(torch.exp(-cls.abs()))
    cls_loss = bce.sum() / denom
    tgt = tgt_px / st
    fgf = fg.float()
    iou_loss = ((1.0 - ciou(pred, tgt)) * fgf).sum() / denom
    ltrb = torch.cat((pts[None] - tgt[..., :2], tgt[..., 2:] - pts[None]), -1).clamp(0.0, reg_max - 1 - 0.01)
    t = ltrb.clamp(0.0, reg_max - 1 - 1e-3)
    lo = t.floor()
    logp = torch.log_softmax(reg.reshape(*reg.shape[:-1], 4, reg_max), -1)
    bins = torch.arange(reg_max, device=reg.device, dtype=torch.float32)
    wgt = (lo + 1 - t)[..., None] * (bins == lo[..., None]) + (t - lo)[..., None] * (bins == lo[..., None] + 1)
    dfl = -(logp * wgt).sum(-1)
    dfl_loss = (dfl * fgf[..., None]).sum() / denom
    return cls_loss + iou_loss + 1.5 * dfl_loss


def detection_loss(out: Dict[str, List], labels: Tensor, gt: Tensor, mask: Tensor, cfg: dict) -> Tensor:
    kw = dict(nc=cfg["nc"], reg_max=cfg["reg_max"], strides=cfg["strides"])
    return (branch_loss(out["one2many"], labels, gt, mask, topk=10, **kw)
            + branch_loss(out["one2one"], labels, gt, mask, topk=1, **kw))


def group_of(name: str) -> str:
    return "backbone" if name.split(".")[0] in ("backbone", "neck") else "head"


class AdamW:
    """Per-group clip, then AdamW (torch's update order: decay, moments,
    bias-corrected step) at a constant learning rate a group."""

    def __init__(self, named: Dict[str, Tensor], cfg: dict) -> None:
        t = cfg["train"]
        self.params = named
        self.lr = {"head": t["lr"], "backbone": t["lr"] * t["bb_lr_mult"]}
        self.wd, self.clip = t["weight_decay"], t["grad_clip"]
        self.b1, self.b2 = t["betas"]
        self.eps = t["eps"]
        self.m = {k: torch.zeros_like(p) for k, p in named.items()}
        self.v = {k: torch.zeros_like(p) for k, p in named.items()}
        self.t = 0

    @torch.no_grad()
    def clip_(self) -> None:
        for g in ("head", "backbone"):
            grads = [p.grad for k, p in self.params.items() if group_of(k) == g and p.grad is not None]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(x) for x in grads]))
            if float(norm) >= self.clip:
                for x in grads:
                    x.mul_(self.clip / norm)

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g, lr = p.grad, self.lr[group_of(k)]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(self.m[k], (self.v[k] / c2).sqrt_().add_(self.eps), value=-lr / c1)
