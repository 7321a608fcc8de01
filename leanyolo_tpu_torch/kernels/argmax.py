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

Both take the first index among equal values. NaN follows JAX's route:
the packed route compares the keys' bits, so a NaN with its sign bit clear
ranks above +inf and one with it set below -inf (lax's total order); the
two-reduce route propagates any NaN (`jnp.max`) and `jnp.argmax` takes the
first one: the max is then the first NaN's bits and the index its place.
A level may be any [B, rows, n] with unit stride in n and evenly strided
rows, e.g. the class slice of a concatenated head map.

`max_argmax_levels` reduces up to four levels' [B, HW_l, n] maps in one
launch, writing each at its column offset in the [B, sum HW_l] outputs, so
the decode needs no concatenation. Bound: bytes (each class logit read
once, a value and an int32 index written a row). The wrapper is the
operator `leanyolo_tpu_torch::max_argmax_levels` (_build.operator).

`max_argmax_flags` is the same launch over the decode's class maps that
also reads the reg maps and writes per-image flags of their non-finite
values (`flags_plain` says what they hold), for the decodes' reproduction
of JAX's one-hot-dot gathers (kernels/gather.py, kernels/dfl.py). The
flags are combined with integer atomics (max and OR) into a buffer zeroed
by a memset, so they are the same on every launch. Bound: bytes (both maps
read once). The wrapper is the operator
`leanyolo_tpu_torch::max_argmax_flags`.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import LAUNCHES
from . import flags as _flags
from ._build import ext, operator
from .gather import gather_bits

_MAX_LEVELS = 4


def packed_route(dtype: torch.dtype, n: int) -> bool:
    """Whether JAX's `max_argmax_lastdim` takes its packed-key route (bf16
    rows of at most 32768), and with it the canonical-zero rule."""
    return dtype == torch.bfloat16 and n <= 32768


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys of float values (bf16 or fp32, -0.0 first mapped to +0.0),
    ascending in lax's total order: -NaN < -inf < ... < +inf < +NaN."""
    x = x.float()
    x = torch.where(x == 0, torch.zeros_like(x), x)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits + 0x80000000)


def max_argmax_plain(x: torch.Tensor, *, canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (max, its first index), int32 indices. canon_zero: the
    largest key in lax's total order; else a NaN first, then the largest
    value as a number."""
    key = _order_key(x)
    if not canon_zero:
        key = torch.where(torch.isnan(x), torch.full_like(key, 1 << 32), key)  # any NaN on top
    idx = key.argmax(dim=-1, keepdim=True)  # the first of the largest
    vals = gather_bits(x, -1, idx).squeeze(-1)
    if canon_zero:
        vals = torch.where(vals == 0, torch.zeros_like(vals), vals)  # -0.0 -> +0.0
    else:
        vals = vals.float()
        # A zero max is +0.0 where the row holds a +0.0: lax's max orders
        # -0.0 below +0.0.
        pos_zero = ((x == 0) & ~torch.signbit(x)).any(dim=-1)
        vals = torch.where((vals == 0) & pos_zero, torch.zeros_like(vals), vals)
    return vals, idx.squeeze(-1).to(torch.int32)


def flags_plain(cls_levels: Sequence[torch.Tensor], reg_levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """int32 [B, 3 nc + 4] flags of the maps' non-finite values, in
    flags.py's layout: per image and class column the first and last anchor
    whose logit is not finite and the largest of their NaN bits; per box
    side whether some anchor's reg_max bins hold a NaN or a +inf, or are all
    -inf (a non-finite DFL)."""
    cls = torch.cat(list(cls_levels), dim=1)  # [B, A, nc]
    b, a, nc = cls.shape
    bad = ~torch.isfinite(cls)
    pos = torch.arange(a, dtype=torch.int64, device=cls.device)[None, :, None]
    zero = torch.zeros((), dtype=torch.int64, device=cls.device)
    lo = torch.where(bad, a - pos, zero).amax(dim=1)
    hi = torch.where(bad, pos + 1, zero).amax(dim=1)
    bits = (cls.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF) | _flags.QUIET_NAN
    nan = torch.where(torch.isnan(cls), bits, zero).amax(dim=1)
    reg = torch.cat(list(reg_levels), dim=1)
    reg = reg.reshape(b, a, _flags.SIDES, reg.shape[-1] // _flags.SIDES)
    side = (torch.isnan(reg) | (reg == float("inf"))).any(dim=-1) | (reg == float("-inf")).all(dim=-1)
    return _flags.pack(lo, hi, nan, side.any(dim=1))


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


def _outputs(levels: List[torch.Tensor], canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the class maps on the card; allocate (vals, idx)."""
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
    return (torch.empty(b, a, dtype=out_dtype, device=x0.device),
            torch.empty(b, a, dtype=torch.int32, device=x0.device))


def _argmax_cuda(levels: List[torch.Tensor], canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_count(levels)
    vals, idx = _outputs(levels, canon_zero)
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


def max_argmax_flags_plain(levels: Sequence[torch.Tensor], reg_levels: Sequence[torch.Tensor], *,
                           canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of `max_argmax_flags`."""
    return (*max_argmax_levels_plain(levels, canon_zero=canon_zero), flags_plain(levels, reg_levels))


def _flags_cpu(levels: List[torch.Tensor], reg_levels: List[torch.Tensor],
               canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_count(levels)
    _check_reg(levels, reg_levels)
    vals, idx, flags = max_argmax_flags_plain(levels, reg_levels, canon_zero=canon_zero)
    return vals.contiguous(), idx.contiguous(), flags


def _flags_fake(levels: List[torch.Tensor], reg_levels: List[torch.Tensor],
                canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    vals, idx = _argmax_fake(levels, canon_zero)
    x0 = levels[0]
    return vals, idx, x0.new_empty((x0.shape[0], _flags.width(x0.shape[2])), dtype=torch.int32)


def _check_reg(levels: List[torch.Tensor], reg_levels: List[torch.Tensor]) -> None:
    if len(reg_levels) != len(levels) or any(r.shape[:2] != c.shape[:2] for r, c in zip(reg_levels, levels)):
        raise ValueError("max_argmax_flags: a reg map [B, rows, 4 * reg_max] for each class map's rows")
    if reg_levels[0].shape[2] % 4 or any(r.shape[2] != reg_levels[0].shape[2] for r in reg_levels):
        raise ValueError("max_argmax_flags: reg maps of one width, 4 * reg_max")


def _flags_cuda(levels: List[torch.Tensor], reg_levels: List[torch.Tensor],
                canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_count(levels)
    _check_reg(levels, reg_levels)
    for x in reg_levels:
        _check(x, "max_argmax_flags reg")
        if x.dtype != levels[0].dtype:
            raise ValueError("max_argmax_flags: reg and class maps of one dtype")
    vals, idx = _outputs(levels, canon_zero)
    flags = torch.empty(vals.shape[0], _flags.width(levels[0].shape[2]), dtype=torch.int32, device=vals.device)
    if vals.numel():
        ext().max_argmax_flags(levels, reg_levels, vals, idx, flags, bool(canon_zero))
        LAUNCHES["argmax"] += 1
    return vals, idx, flags


_MAX_ARGMAX_FLAGS = operator("max_argmax_flags", "(Tensor[] levels, Tensor[] reg_levels, bool canon_zero) -> "
                                                 "(Tensor, Tensor, Tensor)",
                             cpu=_flags_cpu, cuda=_flags_cuda, fake=_flags_fake)


def max_argmax_flags(levels: Sequence[torch.Tensor], reg_levels: Sequence[torch.Tensor], *,
                     canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`max_argmax_levels` of the class maps, plus `flags_plain`'s int32
    [B, 3 nc + 4] flags of them and of the reg maps [B, HW_l, 4 reg_max]
    (the same rows, one dtype), in one launch. Through the operator
    `leanyolo_tpu_torch::max_argmax_flags`."""
    return _MAX_ARGMAX_FLAGS(list(levels), list(reg_levels), canon_zero)
