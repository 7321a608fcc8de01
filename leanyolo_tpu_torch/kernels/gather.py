"""The decode's level gather (K2): rows of k anchors by global index from
per-level maps, as JAX's one-hot dot gives them. Plain version; on the card
it is the key builder of the fused second top-k (kernels/topk.py
`topk_decode`, csrc/topk.cu), which never writes the gathered rows.

Replaces the JAX package's one-hot-dot gather
`leanyolo_tpu/models/yolov10/decode.py:102 _gather_levels` (and its use at
`:168-170`, the class rows of stage 1's anchors). Each gathered element is
a sum over every anchor of the image of `onehot * x`:

- where the column holds only finite values, the selected value added to
  zeros: every value is copied but -0.0, which comes out as +0.0 (on fp32
  maps the second top-k ranks -0.0 below +0.0, so the sign decides the
  order);
- where the column holds a non-finite value at an anchor other than the
  row's own (0 * inf and 0 * NaN are NaN), NaN: the NaN's bits where the
  column holds one (the largest, read unsigned, of several), else
  0xFFC00000, the NaN that 0 * inf gives on the CPU JAX runs on; where the
  row's own anchor is the column's only non-finite one, its value.

The non-finite columns come from `argmax.flags_plain`'s flags (flags.py:
the first and last such anchor and the NaN bits of each column). An index outside
[0, A) gives a zero row, as the one-hot matches no anchor.

Levels are [B, HW_l, C] maps of one dtype (bf16 or fp32), unit stride in C,
rows evenly strided (the class slice of a concatenated [B, H, W, 4R+nc] map
is read in place); idx is int32 [B, k] over the levels' concatenated
anchors.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from . import flags as _flags
from ._build import check_cuda

DOT_NAN = -0x00400000  # 0xFFC00000 as int32: the NaN of 0 * inf on the CPU JAX runs on


def gather_bits(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """`torch.gather` of float values through their bits (the CPU's bf16
    gather rewrites a NaN as 0xFFFF)."""
    bits = torch.int16 if x.element_size() == 2 else torch.int32
    return torch.gather(x.view(bits), dim, idx).view(x.dtype)


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
        g = gather_bits(lv, 1, local.clamp(0, hw - 1)[..., None].expand(-1, -1, c))
        out = torch.where(inside[..., None], g, out)
        off += hw
    return out


def dot_nan(flags: torch.Tensor, idx: torch.Tensor, a: int) -> torch.Tensor:
    """int32 [B, k, nc] bits as fp32: the NaN JAX's one-hot dot writes at
    row (b, j), column c, or 0 where it writes the gathered value."""
    lo, hi, nan = (f[:, None, :] for f in _flags.columns(flags))
    first = a - lo.long()  # the column's first non-finite anchor (a: none)
    last = hi.long() - 1
    own = (first == last) & (first == idx.long()[..., None])
    nan = torch.where(nan != 0, nan, torch.full_like(nan, DOT_NAN))
    return torch.where((first < a) & ~own, nan, torch.zeros_like(nan))


def gather_rows_plain(levels: Sequence[torch.Tensor], idx: torch.Tensor,
                      flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, k, C] in the levels' dtype, JAX's one-hot-dot gather: -0.0 as
    +0.0 and, with `argmax.flags_plain`'s flags of these levels (C = nc),
    the columns' NaNs."""
    g = gather_levels_plain(levels, idx)
    g = torch.where(g == 0, torch.zeros_like(g), g)  # -0.0 -> +0.0
    if flags is None:
        return g
    nan = dot_nan(flags, idx, sum(x.shape[1] for x in levels))
    bits = nan if g.dtype == torch.float32 else (nan >> 16).to(torch.int16)
    return torch.where(nan != 0, bits.view(g.dtype), g)


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
