"""The decode's level gather (K2): rows of k anchors by global index from
per-level maps, in one launch; CUDA kernel (csrc/decode.cu) and plain
version.

Replaces the JAX package's one-hot-dot gather
`leanyolo_tpu/models/yolov10/decode.py:102 _gather_levels` (and its use at
`:168-170`, the class rows of stage 1's anchors). That dot adds each
selected row to zeros, so it copies every value but -0.0, which comes out
as +0.0; the kernel and the plain version write the same. On fp32 maps the
second top-k ranks -0.0 below +0.0, so the sign decides the order. An
index outside [0, A) gives a zero row, as the one-hot matches no anchor.

Levels are [B, HW_l, C] maps of one dtype (bf16 or fp32), unit stride in C,
rows evenly strided (the class slice of a concatenated [B, H, W, 4R+nc] map
is read in place); idx is int32 [B, k] over the levels' concatenated
anchors. Bound: bytes (each selected row read once, written once). The
wrapper is the operator `leanyolo_tpu_torch::gather_rows` (_build.operator).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import LAUNCHES
from ._build import check_cuda, ext, operator

_MAX_LEVELS = 4


def gather_levels_plain(levels: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """Rows idx [B, k] of the levels' concatenation, bits as they are (zero
    rows outside it), without writing the concatenation."""
    b, k = idx.shape
    c = levels[0].shape[-1]
    out = levels[0].new_zeros(b, k, c)
    off = 0
    for lv in levels:
        hw = lv.shape[1]
        local = idx.long() - off
        inside = (local >= 0) & (local < hw)
        g = torch.gather(lv, 1, local.clamp(0, hw - 1)[..., None].expand(-1, -1, c))
        out = torch.where(inside[..., None], g, out)
        off += hw
    return out


def gather_rows_plain(levels: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """Plain version of `gather_rows`."""
    return gather_levels_plain(levels, idx) + 0.0  # -0.0 -> +0.0; the identity elsewhere


def _check_count(levels: List[torch.Tensor]) -> None:
    if not levels or len(levels) > _MAX_LEVELS:
        raise ValueError(f"gather_rows: 1 to {_MAX_LEVELS} levels, got {len(levels)}")


def _gather_cpu(levels: List[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    _check_count(levels)
    return gather_rows_plain(levels, idx).contiguous()


def _gather_fake(levels: List[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    return levels[0].new_empty((idx.shape[0], idx.shape[1], levels[0].shape[2]))


def check_levels(levels: List[torch.Tensor], name: str) -> None:
    """Raise unless the levels are [B, rows, n] CUDA maps of one dtype (bf16
    or fp32), batch and n, unit stride in n."""
    x0 = levels[0]
    for x in levels:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on {x.device}")
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name}: bf16 or fp32 maps, got {x.dtype}")
        if x.ndim != 3 or x.stride(-1) != 1:
            raise ValueError(f"{name}: need [B, rows, n] with unit stride in n, got {tuple(x.shape)} strides "
                             f"{x.stride()}")
        if x.dtype != x0.dtype or x.shape[0] != x0.shape[0] or x.shape[2] != x0.shape[2]:
            raise ValueError(f"{name}: levels differ in dtype, batch or n")


def check_index(idx: torch.Tensor, b: int, name: str) -> None:
    check_cuda(idx, name)
    if idx.dtype != torch.int32 or idx.ndim != 2 or idx.shape[0] != b or idx.shape[1] < 1:
        raise ValueError(f"{name}: int32 [B, k] with k >= 1, got {idx.dtype} {tuple(idx.shape)}")


def _gather_cuda(levels: List[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    _check_count(levels)
    check_levels(levels, "gather_rows")
    x0 = levels[0]
    check_index(idx, x0.shape[0], "gather_rows idx")
    out = torch.empty(x0.shape[0], idx.shape[1], x0.shape[2], dtype=x0.dtype, device=x0.device)
    if out.numel():
        ext().gather_rows(levels, idx, out)
        LAUNCHES["gather_rows"] += 1
    return out


_GATHER_ROWS = operator("gather_rows", "(Tensor[] levels, Tensor idx) -> Tensor",
                        cpu=_gather_cpu, cuda=_gather_cuda, fake=_gather_fake)


def gather_rows(levels: Sequence[torch.Tensor], idx: torch.Tensor) -> torch.Tensor:
    """Per level [B, HW_l, C] (same B, C and dtype), idx int32 [B, k] over the
    levels' concatenated rows -> [B, k, C] in the levels' dtype, -0.0 as
    +0.0. Through the operator `leanyolo_tpu_torch::gather_rows`."""
    return _GATHER_ROWS(list(levels), idx)
