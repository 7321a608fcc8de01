"""Exact greedy NMS over score-sorted candidates, with the compaction of
the survivors: CUDA kernel (csrc/nms.cu) and plain version.

Replaces the JAX package's lax program `leanyolo_tpu/ops/boxes.py:163
_alive_blocked` (reached through `:250 nms_fixed(presorted=True, valid=)`)
and the compaction of `leanyolo_tpu/models/yolov10/decode.py:205
_nms_single`. Greedy NMS in rank order: a candidate survives when it is
valid and no surviving candidate ranked above it overlaps it with
IoU > iou_thresh; invalid candidates never survive and never suppress.
The IoU is `ops/boxes.py::box_iou`'s sequence of fp32 operations, so the
keep set is JAX's bit for bit, also where an IoU lies exactly at the
threshold. Thresholds are rounded to fp32 first, as JAX's fp32 comparisons
round them.

- `nms_keep(boxes, iou_thresh, valid)`: the keep mask [B, n];
- `nms_compact(boxes, scores, cls, ...)`: valid = score > conf_thresh;
  class-wise, the boxes are shifted by cls * group_offset in fp32 before
  the IoU (the JAX decode's offset trick, which at class 79 moves a box by
  6.47e6, where fp32's spacing is 0.5 px: the IoU of the shifted boxes is
  not that of the raw ones); the j-th survivor's unshifted [box, score,
  cls] becomes row j of [B, max_det, 6] while j < min(max_det, n), zero
  rows follow, and num = min(survivors, max_det, n).

Two arithmetic modes, by the dtype of the candidates: fp32, and bf16 as
the JAX decode runs its NMS on bf16 maps (`decode_direct_nms`): the IoU's
operations each rounded to bf16 in `box_iou`'s order (eps bf16(1e-9)),
thresholds rounded to bf16 (JAX's weak-typed Python floats meet a bf16
array in bf16), the class shift in bf16, and the payload the bf16 values
in fp32. A bf16 IoU is not the fp32 IoU rounded: it differs in about 2% of
pairs, so this mode is arithmetic of its own, not an upcast.

The kernel reads the candidates in their own dtype and walks the ranks 32
at a time: each block's survivors are settled from its diagonal IoUs in
registers, then only their IoU rows against the later candidates still
alive are computed, so the work follows survivors x n rather than n^2, and
`nms_compact` stops once its slots are filled; one CTA an image. The
plain version forms the full [B, n, n] IoU matrix and walks the ranks in a
loop vectorised over the batch. Bound: the larger of bytes and
the fp32 IoU operations of the survivors' rows (bounds.nms_work); the chain
of n / 32 settles is latency, which no bound covers.

The wrappers are the operators `leanyolo_tpu_torch::nms_keep` and
`leanyolo_tpu_torch::nms_compact` (_build.operator).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import LAUNCHES
from ._build import check_cuda, ext, operator

GROUP_OFFSET = 8192.0 * 10.0  # the JAX decode's class offset (decode.py:341)


def f32(v: float) -> float:
    """v rounded to fp32, as JAX rounds a Python float it compares with an fp32 array."""
    return float(np.float32(v))


@functools.lru_cache(maxsize=256)
def rounded(v: float, dtype: torch.dtype) -> float:
    """v rounded to fp32, then to `dtype` (bf16: as a weak-typed Python float
    meets a bf16 array in JAX). Cached: a kernel call pays no tensor for it."""
    return float(torch.tensor(f32(v)).to(dtype))


def arithmetic_dtype(boxes: torch.Tensor) -> torch.dtype:
    """The NMS arithmetic for candidates of boxes' dtype: bf16, else fp32."""
    return torch.bfloat16 if boxes.dtype == torch.bfloat16 else torch.float32


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """[..., n, 4] xyxy -> [..., n, n] pairwise IoU, the operations of
    `ops/boxes.py::box_iou` in their order, each rounded to boxes' dtype."""
    wh = torch.clamp_min(boxes[..., 2:4] - boxes[..., 0:2], 0.0)
    area = wh[..., 0] * wh[..., 1]
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:4], boxes[..., None, :, 2:4])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / (union + rounded(1e-9, boxes.dtype))


def nms_keep_plain(boxes: torch.Tensor, iou_thresh: float, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `nms_keep`: boxes [B, n, 4] in rank order -> keep [B, n] bool."""
    b, n = boxes.shape[:2]
    dtype = arithmetic_dtype(boxes)
    rank = torch.arange(n, device=boxes.device)
    supp = (iou_matrix(boxes.to(dtype)) > rounded(iou_thresh, dtype)) & (rank[:, None] < rank[None, :])
    alive = torch.ones(b, n, dtype=torch.bool, device=boxes.device) if valid is None else valid.clone()
    for i in range(n):
        # alive[:, i] is final here: every higher rank has been applied.
        alive &= ~(alive[:, i, None] & supp[:, i])
    return alive


def _shifted(boxes: torch.Tensor, cls: torch.Tensor, group_offset: float) -> torch.Tensor:
    return boxes + (cls * rounded(group_offset, boxes.dtype))[..., None]


def compact_plain(keep: torch.Tensor, boxes: torch.Tensor, scores: torch.Tensor, cls: torch.Tensor,
                  max_det: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stable partition of `_nms_single`: the j-th kept row to slot j
    while j < min(max_det, n), zero rows after; num = min(kept, that).
    JAX moves the rows by a one-hot dot, so where a payload column holds a
    non-finite value (0 * inf = NaN), every slot below min(max_det, n) is
    NaN in that column but the one whose own candidate is the column's only
    non-finite one (written as 0x7FC00000)."""
    b, n = keep.shape
    k_out = min(max_det, n)
    pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    payload = torch.cat([boxes, scores[..., None], cls[..., None]], dim=-1).float()
    dets = torch.zeros(b, max_det, 6, dtype=torch.float32, device=boxes.device)
    own = torch.full((b, max_det), -1, dtype=torch.int64, device=boxes.device)  # each slot's candidate
    bi, ii = (keep & (pos < k_out)).nonzero(as_tuple=True)
    dets[bi, pos[bi, ii].long()] = payload[bi, ii]
    own[bi, pos[bi, ii].long()] = ii
    bad = ~torch.isfinite(payload)  # [B, n, 6]
    rank = torch.arange(n, device=boxes.device)[None, :, None]
    lo = torch.where(bad, rank, n).amin(dim=1)[:, None]  # [B, 1, 6]: the first and last non-finite candidate
    hi = torch.where(bad, rank, -1).amax(dim=1)[:, None]
    mine = (lo == hi) & (lo == own[..., None])
    poison = (lo < n) & ~mine & (torch.arange(max_det, device=boxes.device) < k_out)[None, :, None]
    dets = torch.where(poison, torch.full_like(dets, float("nan")), dets)
    return dets, keep.sum(dim=1).clamp(max=k_out).to(torch.int32)


def nms_compact_plain(boxes: torch.Tensor, scores: torch.Tensor, cls: torch.Tensor, *, iou_thresh: float,
                      conf_thresh: float, max_det: int, class_wise: bool,
                      group_offset: float = GROUP_OFFSET) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `nms_compact`."""
    dtype = arithmetic_dtype(boxes)
    boxes, scores, cls = boxes.to(dtype), scores.to(dtype), cls.to(dtype)
    valid = scores > rounded(conf_thresh, dtype)
    keep = nms_keep_plain(_shifted(boxes, cls, group_offset) if class_wise else boxes, iou_thresh, valid)
    return compact_plain(keep, boxes, scores, cls, max_det)


def _check_boxes(boxes: torch.Tensor) -> None:
    check_cuda(boxes, "nms boxes")
    if boxes.dtype not in (torch.float32, torch.bfloat16) or boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms: boxes [B, n, 4] float32 or bfloat16, got {boxes.dtype} {tuple(boxes.shape)}")


def _keep_cpu(boxes: torch.Tensor, iou_thresh: float, valid: Optional[torch.Tensor]) -> torch.Tensor:
    return nms_keep_plain(boxes, iou_thresh, valid)


def _keep_fake(boxes: torch.Tensor, iou_thresh: float, valid: Optional[torch.Tensor]) -> torch.Tensor:
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


def _keep_cuda(boxes: torch.Tensor, iou_thresh: float, valid: Optional[torch.Tensor]) -> torch.Tensor:
    _check_boxes(boxes)
    if valid is not None:
        valid = valid.to(torch.bool)
        check_cuda(valid, "nms valid")
    keep, _, _ = ext().nms(boxes, None, None, valid, rounded(iou_thresh, boxes.dtype), False, 0.0, False, 0.0, True,
                           0)
    if boxes.numel():
        LAUNCHES["nms"] += 1
    return keep


_NMS_KEEP = operator("nms_keep", "(Tensor boxes, float iou_thresh, Tensor? valid) -> Tensor", cpu=_keep_cpu,
                     cuda=_keep_cuda, fake=_keep_fake)


def nms_keep(boxes: torch.Tensor, iou_thresh: float, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS keep mask [B, n] bool over boxes [B, n, 4] xyxy (fp32, or
    bf16 for the bf16 arithmetic) in descending-score order; valid [B, n]
    bool (None: all valid). Through the operator `leanyolo_tpu_torch::nms_keep`."""
    return _NMS_KEEP(boxes, iou_thresh, valid)


def _compact_cpu(boxes, scores, cls, iou_thresh, conf_thresh, max_det, class_wise, group_offset):
    return nms_compact_plain(boxes, scores, cls, iou_thresh=iou_thresh, conf_thresh=conf_thresh, max_det=max_det,
                             class_wise=class_wise, group_offset=group_offset)


def _compact_fake(boxes, scores, cls, iou_thresh, conf_thresh, max_det, class_wise, group_offset):
    b = boxes.shape[0]
    return boxes.new_empty((b, max_det, 6), dtype=torch.float32), boxes.new_empty((b,), dtype=torch.int32)


def _compact_cuda(boxes, scores, cls, iou_thresh, conf_thresh, max_det, class_wise, group_offset):
    _check_boxes(boxes)
    for t, name in ((scores, "nms scores"), (cls, "nms cls")):
        check_cuda(t, name)
        if t.dtype != boxes.dtype or tuple(t.shape) != tuple(boxes.shape[:2]):
            raise ValueError(f"{name}: [B, n] in the boxes' dtype {boxes.dtype}, got {t.dtype} {tuple(t.shape)}")
    dt = boxes.dtype
    _, dets, num = ext().nms(boxes, scores, cls, None, rounded(iou_thresh, dt), True, rounded(conf_thresh, dt),
                             bool(class_wise), rounded(group_offset, dt), False, int(max_det))
    if boxes.numel():
        LAUNCHES["nms"] += 1
    return dets, num


_NMS_COMPACT = operator(
    "nms_compact", "(Tensor boxes, Tensor scores, Tensor cls, float iou_thresh, float conf_thresh, int max_det, "
    "bool class_wise, float group_offset) -> (Tensor, Tensor)", cpu=_compact_cpu, cuda=_compact_cuda,
    fake=_compact_fake)


def nms_compact(boxes: torch.Tensor, scores: torch.Tensor, cls: torch.Tensor, *, iou_thresh: float,
                conf_thresh: float, max_det: int, class_wise: bool,
                group_offset: float = GROUP_OFFSET) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_nms_single` over a batch: boxes [B, n, 4], scores and cls [B, n],
    all fp32 or all bf16 (the arithmetic's mode), in descending-score order
    -> (dets [B, max_det, 6] fp32, num [B] int32). Through the operator
    `leanyolo_tpu_torch::nms_compact`."""
    return _NMS_COMPACT(boxes, scores, cls, iou_thresh, conf_thresh, max_det, class_wise, group_offset)
