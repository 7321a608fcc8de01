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
The work runs in the assignment's wrapper (kernels/tal.py): two kernels on
the card, its plain version in two passes on the CPU. A background anchor
holds GT slot 0's label and box (target_gt_idx 0) with no foreground and
zero scores, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import tal as _ktal

Tensor = torch.Tensor


class AssignResult(NamedTuple):
    target_labels: Tensor  # [B, A] int32 (slot 0's label for background; num_classes with no GT slot)
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
    return AssignResult(*_ktal.assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk=topk,
                                      num_classes=num_classes, alpha=alpha, beta=beta, eps=eps))
