"""Task-aligned assignment (TAL) on fixed shapes.

Counterpart of the JAX package's `leanyolo_tpu/ops/tal.py` (reference
`leanyolo/utils/tal.py:89-178`): candidate anchors have centres strictly
inside a GT box; the alignment metric is s^0.5 * CIoU^6; each GT keeps its
top-k candidates (k=10 one2many, k=1 one2one); an anchor claimed by several
GTs goes to the GT of highest CIoU; the targets are one-hot class scores
gated by the foreground mask. Padded GTs (mask_gt False) never win.

The assignment runs under `torch.no_grad()`: its outputs are one-hots of
integers and GT boxes, so no gradient reaches the predictions through it in
JAX either. Every argmax takes the first occurrence, as `jnp.argmax` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import box_ciou_pairwise
from .topk import topk_membership

Tensor = torch.Tensor


class AssignResult(NamedTuple):
    target_labels: Tensor  # [B, A] int32 (num_classes for background)
    target_bboxes: Tensor  # [B, A, 4]
    target_scores: Tensor  # [B, A, C] float
    fg_mask: Tensor  # [B, A] bool
    target_gt_idx: Tensor  # [B, A] int32


def select_candidates_in_gts(xy_centers: Tensor, gt_bboxes: Tensor, eps: float = 1e-9) -> Tensor:
    """Anchors with centres inside each GT box. [A, 2] x [B, N, 4] -> [B, N, A] bool."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:]
    deltas = torch.cat((xy_centers[None, None] - lt, rb - xy_centers[None, None]), dim=-1)
    return deltas.amin(dim=-1) > eps


@torch.no_grad()
def task_aligned_assign(
    pd_scores: Tensor,  # [B, A, C] raw logits
    pd_bboxes: Tensor,  # [B, A, 4] xyxy (same space as gt_bboxes)
    anc_points: Tensor,  # [A, 2] (same space as gt_bboxes)
    gt_labels: Tensor,  # [B, N] int
    gt_bboxes: Tensor,  # [B, N, 4] xyxy
    mask_gt: Tensor,  # [B, N] bool
    *,
    topk: int = 10,
    num_classes: int = 80,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
) -> AssignResult:
    b, a, c = pd_scores.shape
    n = gt_labels.shape[1]
    dev = pd_scores.device
    if n == 0:
        return AssignResult(
            torch.full((b, a), num_classes, dtype=torch.int32, device=dev),
            torch.zeros((b, a, 4), dtype=pd_bboxes.dtype, device=dev),
            torch.zeros((b, a, c), dtype=pd_scores.dtype, device=dev),
            torch.zeros((b, a), dtype=torch.bool, device=dev),
            torch.zeros((b, a), dtype=torch.int32, device=dev),
        )

    mask_in_gts = select_candidates_in_gts(anc_points, gt_bboxes) & mask_gt[..., None]  # [B, N, A]
    overlaps = box_ciou_pairwise(gt_bboxes, pd_bboxes)  # [B, N, A]

    probs = torch.sigmoid(pd_scores)
    gt_ind = torch.clamp_min(gt_labels.long(), 0)  # [B, N]
    # probs[b, a, gt[b, n]]: the gather is exact where JAX's one-hot
    # contraction sums one product with zeros.
    cls_scores = torch.gather(probs, 2, gt_ind[:, None, :].expand(b, a, n)).transpose(1, 2)  # [B, N, A]

    align = torch.clamp(cls_scores, 0, 1) ** alpha * torch.clamp(overlaps, 0, 1) ** beta
    align = align * mask_in_gts.to(align.dtype)

    # A GT row whose best metric is <= eps takes {anchor 0}, the reference's
    # masked_fill(0) of all k indices.
    k = min(topk, a)
    has_any = align.amax(dim=-1, keepdim=True) > eps  # [B, N, 1]
    member = topk_membership(align, k)
    anchor0 = (torch.arange(a, device=dev) == 0)[None, None]
    mask_pos = torch.where(has_any, member, anchor0) & mask_in_gts

    # An anchor claimed by several GTs goes to the GT of highest CIoU.
    fg_counts = mask_pos.sum(dim=1)  # [B, A]
    max_overlap_gt = overlaps.argmax(dim=1)  # [B, A]
    is_max = max_overlap_gt[:, None, :] == torch.arange(n, device=dev)[None, :, None]  # [B, N, A]
    mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(dim=1) > 0  # [B, A]

    target_gt_idx = mask_pos.to(torch.int32).argmax(dim=1)  # [B, A]
    target_labels = torch.gather(gt_ind, 1, target_gt_idx)  # [B, A]
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(b, a, 4))  # [B, A, 4]
    onehot = torch.nn.functional.one_hot(target_labels, num_classes).to(pd_scores.dtype)
    target_scores = onehot * fg_mask[..., None].to(pd_scores.dtype)
    return AssignResult(target_labels.to(torch.int32), target_bboxes, target_scores, fg_mask,
                        target_gt_idx.to(torch.int32))
