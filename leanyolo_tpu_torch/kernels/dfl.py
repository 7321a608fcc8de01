"""The selected anchors' DFL box decode (K3), in one launch for all levels:
CUDA kernel (csrc/decode.cu) and plain version.

Replaces the JAX package's dense per-level decode
`leanyolo_tpu/models/yolov10/decode.py:191 _boxes_per_level` with
`ops/anchors.py:73 dfl_expectation`, `:48 dist2bbox` and `:17
make_anchors`, and its gathers at `decode.py:185-187` (top-k) and
`:336-337` (NMS): only the k selected anchors are decoded, in fp32. Per
anchor: its level and cell, the centre (x + 0.5, y + 0.5), per side a
softmax expectation over the reg_max bins, l, t, r, b to x1, y1, x2, y2,
times the level's stride. Two modes:

- NMS: anchor_idx [B, k] -> the candidates' boxes [B, k, 4] (the kernel and
  its operator);
- top-k (the plain version only; on the card the fused second top-k's
  epilogue, kernels/topk.py): pair_idx [B, k] indexes the (anchor, class)
  pairs of anchor_idx [B, k1] (anchor = anchor_idx[pair // nc], class =
  pair % nc) -> the detections [B, k, 6] = box, sigmoid(pair_logits) in
  fp32, class.

JAX gathers the dense boxes by a one-hot dot, so a box side whose DFL is
NaN at any anchor is NaN in every selected box of the image; `flags`
(`argmax.flags_plain`) names those sides. Every NaN is written as
0x7FC00000.

The order of operations is fixed, one rounding an operation, so the kernel
and the plain version are bit-equal on the card: m = the bins' max; e_i =
exp(v_i - m); den and num summed left to right over the bins (num of e_i *
i); d = num / den; (a - d) * stride and (a + d) * stride; torch.sigmoid's
1 / (1 + exp(-x)). JAX's softmax then dot differs from it in the last bits
(a few fp32 ulps of a pixel coordinate).

Reg maps: [B, HW_l, 4 * reg_max] bf16 or fp32, unit stride in the bins, rows
evenly strided (the reg slice of a concatenated map is read in place). The
kernel takes reg_max = 16, every configuration's (models/yolov10/config.py);
the plain version any. Bound: bytes. The wrapper is the operator
`leanyolo_tpu_torch::dfl_boxes` (_build.operator).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import LAUNCHES
from . import flags as _flags
from ._build import ext, operator
from .gather import check_index, check_levels, gather_levels_plain

REG_MAX = 16  # the kernel's bins a side
_MAX_LEVELS = 4


def _cells(widths: Sequence[int], strides: Sequence[float], rows: Sequence[int], g: torch.Tensor):
    """Anchor centres (x + 0.5, y + 0.5) in cells and strides, fp32, of the
    global anchor indices g (zero outside the levels)."""
    ax = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    ay, s = torch.zeros_like(ax), torch.zeros_like(ax)
    off = 0
    for w, st, hw in zip(widths, strides, rows):
        local = g - off
        inside = (local >= 0) & (local < hw)
        ax = torch.where(inside, (local % w).float() + 0.5, ax)
        ay = torch.where(inside, torch.div(local, w, rounding_mode="floor").float() + 0.5, ay)
        s = torch.where(inside, torch.full_like(s, float(st)), s)
        off += hw
    return ax, ay, s


def dfl_boxes_plain(levels: Sequence[torch.Tensor], hw_shapes: Sequence[Tuple[int, int]], strides: Sequence[float],
                    anchor_idx: torch.Tensor, pair_idx: Optional[torch.Tensor] = None,
                    pair_logits: Optional[torch.Tensor] = None, num_classes: int = 0,
                    flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of `dfl_boxes` (the same arguments), for any reg_max;
    with pair_idx and pair_logits, top-k mode (the fused second top-k's
    epilogue, kernels/topk.py)."""
    if pair_idx is not None:
        rel = torch.div(pair_idx.long(), num_classes, rounding_mode="floor")
        g = torch.gather(anchor_idx.long(), 1, rel)
    else:
        g = anchor_idx.long()
    reg_max = levels[0].shape[-1] // 4
    v = gather_levels_plain(levels, g).float()
    v = v.reshape(v.shape[:-1] + (4, reg_max))
    e = torch.exp(v - v.amax(dim=-1, keepdim=True))
    w = e * torch.arange(reg_max, dtype=torch.float32, device=e.device)
    den, num = e[..., 0], w[..., 0]
    for i in range(1, reg_max):  # left to right, as the kernel sums
        den = den + e[..., i]
        num = num + w[..., i]
    d = num / den  # [B, k, 4]: l, t, r, b in cells
    ax, ay, s = _cells([int(w) for _, w in hw_shapes], strides, [x.shape[1] for x in levels], g)
    out = torch.stack(((ax - d[..., 0]) * s, (ay - d[..., 1]) * s, (ax + d[..., 2]) * s, (ay + d[..., 3]) * s),
                      dim=-1)
    inside = (g >= 0) & (g < sum(x.shape[1] for x in levels))
    out = torch.where(inside[..., None], out, torch.zeros_like(out))
    if flags is not None:
        # JAX's dot spreads a side's NaN to every row of the image.
        out = torch.where(_flags.sides(flags)[:, None, :], torch.full_like(out, float("nan")), out)
    out = _canon_nan(out)
    if pair_idx is None:
        return out
    score = _canon_nan(torch.sigmoid(pair_logits.float()))
    cls = (pair_idx.long() % num_classes).float()
    return torch.cat([out, score[..., None], cls[..., None]], dim=-1)


def _canon_nan(x: torch.Tensor) -> torch.Tensor:
    """Every NaN as 0x7FC00000, as the kernels write it."""
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)


def _check_count(levels: List[torch.Tensor], widths: List[int], strides: List[float]) -> None:
    if not levels or len(levels) > _MAX_LEVELS or len(widths) != len(levels) or len(strides) != len(levels):
        raise ValueError(f"dfl_boxes: 1 to {_MAX_LEVELS} levels, each with a width and a stride; got "
                         f"{len(levels)}, {len(widths)}, {len(strides)}")
    for x, w in zip(levels, widths):
        if w < 1 or x.shape[1] % w:
            raise ValueError(f"dfl_boxes: a level of {x.shape[1]} rows is not h x {w} cells")


def _dfl_cpu(levels: List[torch.Tensor], widths: List[int], strides: List[float], anchor_idx: torch.Tensor,
             flags: Optional[torch.Tensor]) -> torch.Tensor:
    _check_count(levels, widths, strides)
    hw_shapes = [(x.shape[1] // w, w) for x, w in zip(levels, widths)]
    return dfl_boxes_plain(levels, hw_shapes, strides, anchor_idx, flags=flags).contiguous()


def _dfl_fake(levels: List[torch.Tensor], widths: List[int], strides: List[float], anchor_idx: torch.Tensor,
              flags: Optional[torch.Tensor]) -> torch.Tensor:
    return anchor_idx.new_empty((anchor_idx.shape[0], anchor_idx.shape[1], 4), dtype=torch.float32)


def check_reg(levels: List[torch.Tensor], name: str) -> None:
    """Raise unless the levels are reg maps on the card with rows of 4 x REG_MAX bins."""
    check_levels(levels, name)
    if levels[0].shape[2] != 4 * REG_MAX:
        raise ValueError(f"{name}: the kernel takes reg_max {REG_MAX} (rows of {4 * REG_MAX}), got rows of "
                         f"{levels[0].shape[2]}")


def _dfl_cuda(levels: List[torch.Tensor], widths: List[int], strides: List[float], anchor_idx: torch.Tensor,
              flags: Optional[torch.Tensor]) -> torch.Tensor:
    _check_count(levels, widths, strides)
    check_reg(levels, "dfl_boxes")
    b = levels[0].shape[0]
    check_index(anchor_idx, b, "dfl_boxes anchor_idx")
    if flags is not None:
        _flags.check(flags, b, None, "dfl_boxes flags")
    out = torch.empty(b, anchor_idx.shape[1], 4, dtype=torch.float32, device=levels[0].device)
    if out.numel():
        ext().dfl_boxes(levels, widths, strides, anchor_idx, flags, out)
        LAUNCHES["dfl_boxes"] += 1
    return out


_DFL_BOXES = operator("dfl_boxes", "(Tensor[] levels, int[] widths, float[] strides, Tensor anchor_idx, "
                                   "Tensor? flags) -> Tensor",
                      cpu=_dfl_cpu, cuda=_dfl_cuda, fake=_dfl_fake)


def dfl_boxes(levels: Sequence[torch.Tensor], hw_shapes: Sequence[Tuple[int, int]], strides: Sequence[float],
              anchor_idx: torch.Tensor, flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reg maps [B, HW_l, 4 * reg_max] of levels with (h, w) shapes and
    strides, anchor_idx int32 [B, k] over their concatenated anchors -> fp32
    [B, k, 4] xyxy pixel boxes. flags: `argmax.flags_plain`'s [B, 3 nc + 4]
    of these maps: each side flagged non-finite is NaN in every box of its
    image, as JAX's one-hot-dot gather gives it (None: a true gather, as
    JAX's export takes). Through the operator
    `leanyolo_tpu_torch::dfl_boxes`."""
    return _DFL_BOXES(list(levels), [int(w) for _, w in hw_shapes], [float(s) for s in strides], anchor_idx, flags)
