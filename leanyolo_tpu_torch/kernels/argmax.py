"""Fused per-row (max, first argmax) over the last dim: CUDA kernel
(csrc/argmax.cu) and plain version.

Replaces the JAX package's hand-shaped lax op
`leanyolo_tpu/ops/topk.py:90 max_argmax_lastdim`, the per-anchor best class
of the NMS decode; the top-k decode's stage 1 takes its max (`jnp.max`). JAX gives it two routes, and the signed-zero rule
depends on the route (`packed_route` names JAX's choice), so the caller
passes it (`canon_zero`, as for top-k):

- `canon_zero=True`, the packed bf16 route: -0.0 is first mapped to +0.0,
  so the two zeros tie and the max of a row of zeros is +0.0; the values
  come back in the input's dtype;
- `canon_zero=False`, the two-reduce route (`jnp.max`, `jnp.argmax`): the
  max orders -0.0 below +0.0 (the max of [-0.0, 0.0] is +0.0, where
  `torch.amax` gives -0.0), and the index is the first whose value
  compares equal to the max (index 0 of [-0.0, 0.0]); the values come back
  as fp32, which is exact for a bf16 input.

Both take the first index among equal values. NaN is outside the contract
(the head maps are finite). A level may be any [B, rows, n] with unit stride
in n and evenly strided rows, e.g. the class slice of a concatenated head
map.

`max_argmax_levels` reduces up to four levels' [B, HW_l, n] maps in one
launch, writing each at its column offset in the [B, sum HW_l] outputs, so
the decode needs no concatenation. Bound: bytes (each class logit read
once, a value and an int32 index written a row). The wrapper is the
operator `leanyolo_tpu_torch::max_argmax_levels` (_build.operator).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import LAUNCHES
from ._build import ext, operator

_MAX_LEVELS = 4


def packed_route(dtype: torch.dtype, n: int) -> bool:
    """Whether JAX's `max_argmax_lastdim` takes its packed-key route (bf16
    rows of at most 32768), and with it the canonical-zero rule."""
    return dtype == torch.bfloat16 and n <= 32768


def max_argmax_plain(x: torch.Tensor, *, canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (max, first index of a value equal to it), int32 indices."""
    if canon_zero:
        x = x + 0.0  # -0.0 -> +0.0; the identity elsewhere
        vals = x.amax(dim=-1)
    else:
        vals = x.amax(dim=-1)
        # torch.amax may return -0.0 where the row holds +0.0: lax's max
        # orders -0.0 below +0.0.
        pos_zero = ((x == 0) & ~torch.signbit(x)).any(dim=-1)
        vals = torch.where((vals == 0) & pos_zero, torch.zeros_like(vals), vals)
    idx = (x == vals.unsqueeze(-1)).to(torch.uint8).argmax(dim=-1).to(torch.int32)
    return (vals if canon_zero else vals.float()), idx


def max_argmax_levels_plain(levels: Sequence[torch.Tensor], *, canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `max_argmax_levels`."""
    pairs = [max_argmax_plain(x, canon_zero=canon_zero) for x in levels]
    return torch.cat([v for v, _ in pairs], dim=1), torch.cat([i for _, i in pairs], dim=1)


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: bf16 or fp32 input, got {x.dtype}")
    if x.ndim != 3 or x.stride(-1) != 1:
        raise ValueError(f"{name}: need [B, rows, n] with unit stride in n, got {tuple(x.shape)} "
                         f"strides {x.stride()}")


def _check_count(levels: List[torch.Tensor]) -> None:
    if not levels or len(levels) > _MAX_LEVELS:
        raise ValueError(f"max_argmax_levels: 1 to {_MAX_LEVELS} levels, got {len(levels)}")


def _argmax_cpu(levels: List[torch.Tensor], canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_count(levels)
    vals, idx = max_argmax_levels_plain(levels, canon_zero=canon_zero)
    return vals.contiguous(), idx.contiguous()


def _argmax_fake(levels: List[torch.Tensor], canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    x0 = levels[0]
    shape = (x0.shape[0], sum(x.shape[1] for x in levels))
    return (x0.new_empty(shape, dtype=x0.dtype if canon_zero else torch.float32),
            x0.new_empty(shape, dtype=torch.int32))


def _argmax_cuda(levels: List[torch.Tensor], canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_count(levels)
    x0 = levels[0]
    for x in levels:
        _check(x, "max_argmax")
        if x.dtype != x0.dtype or x.shape[0] != x0.shape[0] or x.shape[2] != x0.shape[2]:
            raise ValueError("max_argmax_levels: levels differ in dtype, batch or n")
    b, n = x0.shape[0], x0.shape[2]
    if n == 0:
        raise ValueError("max_argmax: empty rows have no max")
    a = sum(x.shape[1] for x in levels)
    out_dtype = x0.dtype if canon_zero else torch.float32
    vals = torch.empty(b, a, dtype=out_dtype, device=x0.device)
    idx = torch.empty(b, a, dtype=torch.int32, device=x0.device)
    if vals.numel():
        ext().max_argmax(levels, vals, idx, bool(canon_zero))
        LAUNCHES["argmax"] += 1
    return vals, idx


_MAX_ARGMAX = operator("max_argmax_levels", "(Tensor[] levels, bool canon_zero) -> (Tensor, Tensor)",
                       cpu=_argmax_cpu, cuda=_argmax_cuda, fake=_argmax_fake)


def max_argmax_levels(levels: Sequence[torch.Tensor], *, canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per level [B, HW_l, n] (same B, n and dtype) -> (vals [B, sum HW_l],
    idx [B, sum HW_l] int32), level l's rows at offset sum_{k<l} HW_k. Values
    in the input's dtype with `canon_zero`, else fp32. Through the operator
    `leanyolo_tpu_torch::max_argmax_levels`."""
    return _MAX_ARGMAX(list(levels), canon_zero)
