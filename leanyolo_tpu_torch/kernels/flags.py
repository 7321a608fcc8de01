"""The layout of the decodes' per-image non-finite flags, in one place.

K4's flagging launch (argmax.py `max_argmax_flags`, `flags_plain`) writes
them; the level gather's plain version (gather.py), the box decode (dfl.py)
and the fused second top-k (topk.py) read them. On the card the same layout
is `DecodeFlags` in csrc/kernels.h.

A row of int32 [B, 3 nc + 4] an image, over the levels' concatenated
anchors (A of them), words read unsigned:

- `lo` (words 0 .. nc): for class column c, A - the first anchor whose
  logit in c is not finite (0: none);
- `hi` (nc .. 2 nc): 1 + the last such anchor;
- `nan` (2 nc .. 3 nc): the largest of those logits' NaN bits as fp32 with
  the quiet bit set (0: no NaN);
- `side` (3 nc .. 3 nc + 4): 1 where box side s (l, t, r, b) of some anchor
  has a non-finite DFL.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import check_cuda

QUIET_NAN = 0x00400000  # the quiet bit of an fp32 NaN (bf16's, in its high half)
SIDES = 4


def width(nc: int) -> int:
    """Words a row: three a class column, one a box side."""
    return 3 * nc + SIDES


def num_classes(flags: torch.Tensor) -> int:
    return (flags.shape[-1] - SIDES) // 3


def pack(lo: torch.Tensor, hi: torch.Tensor, nan: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """int64 words [B, nc] x 3 and [B, 4] -> the int32 rows (unsigned words as int32)."""
    out = torch.cat([lo, hi, nan, side.to(torch.int64)], dim=1)
    return (out - (out >= 0x80000000).to(torch.int64) * (1 << 32)).to(torch.int32)


def columns(flags: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo, hi, nan), each [B, nc]."""
    nc = num_classes(flags)
    return flags[:, :nc], flags[:, nc:2 * nc], flags[:, 2 * nc:3 * nc]


def sides(flags: torch.Tensor) -> torch.Tensor:
    """[B, 4] bool: the box sides flagged non-finite."""
    return flags[:, -SIDES:] != 0


def check(flags: torch.Tensor, b: int, nc: Optional[int], name: str) -> None:
    """Raise unless flags are int32 [b, width(nc)] on the card (any nc where None)."""
    check_cuda(flags, name)
    w = flags.shape[-1] if flags.ndim == 2 else -1
    ok = (w >= SIDES and (w - SIDES) % 3 == 0) if nc is None else w == width(nc)
    if flags.dtype != torch.int32 or flags.ndim != 2 or flags.shape[0] != b or not ok:
        raise ValueError(f"{name}: int32 [B, 3 nc + 4] flags, got {flags.dtype} {tuple(flags.shape)}")
