"""The task-aligned assignment (TAL) of the training loss: two CUDA kernels
(csrc/tal.cu) behind one wrapper, and the plain version.

Replaces the hand-shaped lax program of the JAX package's
`leanyolo_tpu/ops/tal.py:47 task_aligned_assign`, with `ops/boxes.py:49
box_ciou_pairwise` (K7: the pairwise CIoU and the alignment metric) and
`ops/topk.py:113 topk_membership` (K6: each GT's top-k set of anchors).
`ops/tal.py::task_aligned_assign` calls `assign`, twice a training step
(one2many at k = 10, one2one at k = 1).

`assign(pd_scores [B, A, C], pd_bboxes [B, A, 4], anc_points [A, 2],
gt_labels [B, N], gt_bboxes [B, N, 4], mask_gt [B, N], topk, num_classes)`
-> (target_labels [B, A] int32, target_bboxes [B, A, 4], target_scores [B,
A, num_classes] in pd_scores' dtype, fg_mask [B, A] bool, target_gt_idx [B,
A] int32), in two passes:

1. candidates (on the card a cluster of 8 CTAs an image, each a chunk of
   its anchors, a warp a GT row, the chunks' winners merged through the
   cluster's shared memory): the inside test, the CIoU of each GT against
   each predicted box, the sigmoid of the GT class's logit, align =
   clamp(s, 0, 1) ** alpha * clamp(CIoU, 0, 1) ** beta * inside; the row's
   k winners by (align desc, index asc), torch.argmax's and lax.top_k's
   order, and has_any = max(align) > eps. With k >= A every anchor is a
   member. A padded row's align is all zero. Outside the box align is
   t * 0, +0.0 unless t is NaN: the kernel skips the chain only where a
   cheap test proves t is not NaN (a non-NaN logit, every box coordinate
   finite and at most 1e18 in magnitude).
2. targets (a thread an anchor): GT n claims the anchor where mask_gt, inside
   and membership (the winners, or anchor 0 where has_any is false) hold;
   one claim takes that GT, several the GT of highest CIoU over every slot,
   padded ones included, first occurrence; none takes slot 0 with no
   foreground. Background rows therefore hold slot 0's label and box, as in
   JAX. The one-hot scores are zero off the foreground and for a label >=
   num_classes.

Every output is a discrete function of the decisions (one-hots, copied GT
rows, indices), so the kernels and the plain version agree bit for bit on
the card: the kernels round after each operation where torch's operations
do (csrc/tal.cu), and `assign(..., check=True)` also returns the CIoU and
the alignment [B, N, A] so a caller can hold those to the plain version's
bits. An image's result depends on its own rows only.

On the card: pd_scores, the boxes and the anchors fp32 (the loss runs in
fp32); pd_scores with unit stride in C, read in place through its row
stride (the concatenated head's class slice); k at most MAX_K unless k >=
A; the reference's exponents, alpha 0.5 and beta 6 (the plain version
takes any); labels < C (the plain version's gather refuses others); A
at most MAX_A. `LAUNCHES["tal_candidates"]` and `["tal_targets"]` count
the two kernels. CPU tensors take the plain version; CUDA tensors launch
the kernels or raise. Like mpbwd and bnstats this wrapper is not a
`torch.library` operator: only the training path calls it.

Bound on an H100: bytes (bounds.tal_work): every logit of an image with a
valid slot read once by the candidates (86 MB at the step's [32, 16, 8400]
and 80 classes), the outputs written once by the targets (95 MB, most of
them the one-hot scores); the operations (the SASS counts of
tools/tal_pair_ops: 16 a pair of a valid slot, 218 a pair inside its box)
come to a third of the candidates' byte time or less.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import LAUNCHES
from ._build import ext

MAX_K = 16  # winners a GT row the candidates kernel keeps (csrc/kernels.h TAL_MAX_K)
MAX_A = 8 * 6016  # anchors the candidates kernel stages (TAL_CLUSTER chunks of TAL_MAX_CHUNK)
CV = 4 / (math.pi ** 2)  # the CIoU's aspect-ratio constant, as ops/boxes.py writes it
# The alignment's exponents the kernels compute (the reference's), by torch's
# routes on the card: ** 0.5 is sqrt, ** 6 is powf.
ALPHA, BETA = 0.5, 6.0

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _empty(pd_scores, pd_bboxes, num_classes: int) -> Outputs:
    """The outputs with no GT slot: background everywhere."""
    b, a, _ = pd_scores.shape
    dev = pd_scores.device
    return (torch.full((b, a), num_classes, dtype=torch.int32, device=dev),
            torch.zeros((b, a, 4), dtype=pd_bboxes.dtype, device=dev),
            torch.zeros((b, a, num_classes), dtype=pd_scores.dtype, device=dev),
            torch.zeros((b, a), dtype=torch.bool, device=dev),
            torch.zeros((b, a), dtype=torch.int32, device=dev))


def candidates_plain(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, k: int, *,
                     alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9):
    """Pass 1: (winners [B, N, k] int64 in rank order, or None where every
    anchor is a member (k >= A); has_any [B, N] bool; mask_in [B, N, A] bool
    (inside and mask_gt); overlaps, align [B, N, A])."""
    from ..ops.boxes import box_ciou_pairwise
    from ..ops.tal import select_candidates_in_gts

    b, a, _ = pd_scores.shape
    n = gt_labels.shape[1]
    mask_in = select_candidates_in_gts(anc_points, gt_bboxes) & mask_gt[..., None]  # [B, N, A]
    overlaps = box_ciou_pairwise(gt_bboxes, pd_bboxes)  # [B, N, A]
    probs = torch.sigmoid(pd_scores)
    gt_ind = torch.clamp_min(gt_labels.long(), 0)  # [B, N]
    # probs[b, a, gt[b, n]]: the gather is exact where JAX's one-hot
    # contraction sums one product with zeros ...
    cls_scores = torch.gather(probs, 2, gt_ind[:, None, :].expand(b, a, n)).transpose(1, 2)  # [B, N, A]
    # ... and NaN wherever any class logit of the anchor is NaN: the
    # contraction's zero products with a NaN are NaN (0 for a label >= C
    # otherwise).
    cls_scores = cls_scores.masked_fill(torch.isnan(pd_scores).any(-1)[:, None, :], float("nan"))
    align = torch.clamp(cls_scores, 0, 1) ** alpha * torch.clamp(overlaps, 0, 1) ** beta
    align = align * mask_in.to(align.dtype)
    # A GT row whose best metric is <= eps takes {anchor 0}, the reference's
    # masked_fill(0) of all k indices.
    has_any = align.amax(dim=-1) > eps
    winners = None
    if k < a:  # k rounds of first-occurrence argmax, each winner masked to -inf (JAX's topk_membership)
        xm, rounds = align.clone(), []
        for _ in range(k):
            i = xm.argmax(dim=-1, keepdim=True)
            rounds.append(i)
            xm.scatter_(-1, i, float("-inf"))
        winners = torch.cat(rounds, dim=-1) if rounds else gt_labels.new_zeros((b, n, 0), dtype=torch.long)
    return winners, has_any, mask_in, overlaps, align


def targets_plain(winners, has_any, mask_in, overlaps, gt_labels, gt_bboxes, num_classes: int,
                  dtype: torch.dtype) -> Outputs:
    """Pass 2, the per-anchor resolve, over pass 1's results."""
    b, n, a = mask_in.shape
    dev = mask_in.device
    if winners is None:
        member = torch.ones_like(mask_in)
    else:
        member = torch.zeros_like(mask_in).scatter_(2, winners, True)
    anchor0 = (torch.arange(a, device=dev) == 0)[None, None]
    mask_pos = torch.where(has_any[..., None], member, anchor0) & mask_in

    # An anchor claimed by several GTs goes to the GT of highest CIoU.
    fg_counts = mask_pos.sum(dim=1)  # [B, A]
    max_overlap_gt = overlaps.argmax(dim=1)  # [B, A]
    is_max = max_overlap_gt[:, None, :] == torch.arange(n, device=dev)[None, :, None]  # [B, N, A]
    mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(dim=1) > 0  # [B, A]

    target_gt_idx = mask_pos.to(torch.int32).argmax(dim=1)  # [B, A]
    gt_ind = torch.clamp_min(gt_labels.long(), 0)
    target_labels = torch.gather(gt_ind, 1, target_gt_idx)  # [B, A]
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(b, a, 4))  # [B, A, 4]
    # JAX's one_hot: zeros for a label outside [0, num_classes).
    onehot = target_labels[..., None] == torch.arange(num_classes, device=dev)
    target_scores = (onehot & fg_mask[..., None]).to(dtype)
    return (target_labels.to(torch.int32), target_bboxes, target_scores, fg_mask, target_gt_idx.to(torch.int32))


def assign_plain(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, *, topk: int = 10,
                 num_classes: int = 80, alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9,
                 check: bool = False):
    """Plain version of `assign`, on any device."""
    if gt_labels.shape[1] == 0:
        return _check_out(_empty(pd_scores, pd_bboxes, num_classes), None, check)
    k = min(topk, pd_scores.shape[1])
    winners, has_any, mask_in, overlaps, align = candidates_plain(
        pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, k, alpha=alpha, beta=beta, eps=eps)
    out = targets_plain(winners, has_any, mask_in, overlaps, gt_labels, gt_bboxes, num_classes, pd_scores.dtype)
    return _check_out(out, (overlaps, align), check)


def _check_out(out: Outputs, mid: Optional[tuple], check: bool):
    return (out, mid) if check else out


def _inputs(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk: int, alpha: float = ALPHA,
            beta: float = BETA):
    """The kernels' inputs on the card, checked: (pd_bboxes, anchors,
    int32 labels, gt_bboxes, bool mask, k, all_members)."""
    if (alpha, beta) != (ALPHA, BETA):
        raise ValueError(f"tal: the card computes alpha {ALPHA} and beta {BETA}, got {alpha} and {beta}")
    if pd_scores.device.type != "cuda":
        raise ValueError(f"tal: expected a CUDA or CPU tensor, got one on {pd_scores.device}")
    if pd_scores.dtype != torch.float32 or pd_scores.stride(2) != 1:
        raise ValueError(f"tal: pd_scores must be float32 with unit stride in C on the card, got {pd_scores.dtype}")
    if not all(t.dtype == torch.float32 for t in (pd_bboxes, anc_points, gt_bboxes)):
        raise ValueError("tal: pd_bboxes, anc_points and gt_bboxes must be float32 on the card")
    a = pd_scores.shape[1]
    k = min(topk, a)
    if k < a and k > MAX_K:
        raise ValueError(f"tal: topk {topk} above the kernel's {MAX_K} (and below A = {a})")
    if a > MAX_A:
        raise ValueError(f"tal: A = {a} anchors above the candidates kernel's {MAX_A}")
    pd_bboxes, gt_bboxes = (t.contiguous() for t in (pd_bboxes, gt_bboxes))
    pd_bboxes, gt_bboxes = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (pd_bboxes, gt_bboxes))
    return (pd_bboxes, anc_points.contiguous(), gt_labels.to(torch.int32).contiguous(), gt_bboxes,
            mask_gt.to(torch.bool).contiguous(), k, k >= a)


def candidates(pd_scores, inputs: tuple, *, eps: float = 1e-9, check: bool = False):
    """The candidates kernel on `_inputs`: [winners [B, N, MAX_K] int32 (the
    first k of a valid row, in rank order), has_any [B, N] uint8], then the
    CIoU and the alignment [B, N, A] of every row in check mode."""
    pd_bboxes, anc, labels, gt_bboxes, mask, k, every = inputs
    out = ext().tal_candidates(pd_scores, pd_bboxes, anc, labels, gt_bboxes, mask, k, every, BETA, eps, CV, check)
    LAUNCHES["tal_candidates"] += 1
    return out


def targets(inputs: tuple, winners, has_any, num_classes: int) -> Outputs:
    """The targets kernel on `_inputs` and the candidates kernel's results:
    the five outputs."""
    pd_bboxes, anc, labels, gt_bboxes, mask, k, every = inputs
    out = ext().tal_targets(pd_bboxes, anc, labels, gt_bboxes, mask, winners, has_any, k, every, num_classes, CV)
    LAUNCHES["tal_targets"] += 1
    return tuple(out)


def assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, *, topk: int = 10,
           num_classes: int = 80, alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9, check: bool = False):
    """The assignment's five outputs (the module doc); with check=True,
    (outputs, (overlaps, align)), the kernels writing every row's CIoU and
    alignment [B, N, A] as well (a check-only mode)."""
    if pd_scores.device.type == "cpu":
        return assign_plain(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk=topk,
                            num_classes=num_classes, alpha=alpha, beta=beta, eps=eps, check=check)
    if gt_labels.shape[1] == 0:
        return _check_out(_empty(pd_scores, pd_bboxes, num_classes), None, check)
    inputs = _inputs(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, topk, alpha, beta)
    cand = candidates(pd_scores, inputs, eps=eps, check=check)
    out = targets(inputs, cand[0], cand[1], num_classes)
    return _check_out(out, tuple(cand[2:]), check)
