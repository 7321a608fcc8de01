"""Exact top-k over the last dimension with lax.top_k's tie rule.

Counterpart of the JAX package's `leanyolo_tpu/ops/topk.py:37-167`. The
JAX function takes one of three routes, and the tie rule for signed zeros
depends on the route, so the port picks the same rule per call:

- k == 1: max/argmax, first occurrence; -0.0 ties +0.0;
- bf16, k < n <= 32768: the packed s32 keys; -0.0 ties +0.0;
- otherwise (fp32, k == n, longer rows): lax.top_k; -0.0 ranks below +0.0.

Equal values always resolve to the lower index first. Any 1 <= k <= n, as
in JAX (no cap on k). The work runs in the top-k kernel wrapper
(kernels/topk.py). `max_argmax_lastdim` (JAX `topk.py:90`) runs in the
fused max/argmax kernel's wrapper (kernels/argmax.py), with the signed-zero
rule of JAX's route for the input.

Both take `dtype`: rank as JAX would rank x cast to that dtype, without
making the cast, which must be exact (bf16 maps ranked as their fp32
upcast, as JAX's predictor ranks them); the values come back in it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ..kernels import argmax as _kargmax
from ..kernels import topk as _ktopk
from ..kernels.topk import pack_bf16_desc, unpack_bf16_desc  # noqa: F401  (re-export)


def _rank_dtype(have: torch.dtype, dtype: Optional[torch.dtype]) -> torch.dtype:
    if dtype is None or dtype == have:
        return have
    if have == torch.bfloat16 and dtype == torch.float32:
        return dtype
    raise ValueError(f"cannot rank {have} values as {dtype}: the cast is not exact")


def topk_lastdim(x: torch.Tensor, k: int, *, dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (values, int32 indices) over the last dimension."""
    dtype = _rank_dtype(x.dtype, dtype)
    n = x.shape[-1]
    canon = k == 1 or (dtype == torch.bfloat16 and k < n <= 32768)
    vals, idx = _ktopk.topk(x, k, canon_zero=canon)
    return vals.to(dtype), idx


def max_argmax_lastdim(x: Union[torch.Tensor, Sequence[torch.Tensor]], *,
                       dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, first argmax int32) over the last dimension. bf16 rows of at
    most 32768: JAX's packed route (-0.0 ties +0.0, the max of zeros is
    +0.0); otherwise its two-reduce route (-0.0 below +0.0 in the max; the
    index is the first equal to the max).

    x: a tensor [..., n] -> outputs [...]; or per-level maps [B, HW_l, n]
    of one dtype -> outputs [B, sum HW_l], level l at its row offset, in
    one launch.
    """
    levels = list(x) if isinstance(x, (list, tuple)) else [x.contiguous().reshape(1, -1, x.shape[-1])]
    dtype = _rank_dtype(levels[0].dtype, dtype)
    canon = _kargmax.packed_route(dtype, levels[0].shape[-1])
    vals, idx = _kargmax.max_argmax_levels(levels, canon_zero=canon)
    vals = vals.to(dtype)
    if torch.is_tensor(x):
        vals, idx = vals.reshape(x.shape[:-1]), idx.reshape(x.shape[:-1])
    return vals, idx


def topk_membership(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean top-k membership over the last dimension (no order): k rounds
    of first-occurrence argmax, each masking its winner to -inf, so equal
    values are admitted in ascending index order as lax.top_k admits them
    (JAX `ops/topk.py:113-143`). The TAL assignment's candidate sets; a plain
    PyTorch version, its kernel (K6) is later work.
    """
    n = x.shape[-1]
    if k >= n:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    neg = float("-inf") if x.is_floating_point() else torch.iinfo(x.dtype).min
    iota = torch.arange(n, device=x.device)
    sel = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    xm = x
    for _ in range(k):
        hit = xm.argmax(dim=-1, keepdim=True) == iota
        sel = sel | hit
        xm = torch.where(hit, neg, xm)
    return sel
