"""Exact top-k over the last dimension with lax.top_k's tie rule.

Counterpart of the JAX package's `leanyolo_tpu/ops/topk.py:37-167`. The
JAX function takes one of three routes, and the tie rule for signed zeros
depends on the route, so the port picks the same rule per call:

- k == 1: max/argmax, first occurrence; -0.0 ties +0.0;
- bf16, k < n <= 32768: the packed s32 keys; -0.0 ties +0.0;
- otherwise (fp32, k == n, longer rows): lax.top_k; -0.0 ranks below +0.0.

Equal values always resolve to the lower index first. Any 1 <= k <= n, as
in JAX (no cap on k). The work runs in the top-k kernel wrapper
(kernels/topk.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import topk as _ktopk
from ..kernels.topk import pack_bf16_desc, unpack_bf16_desc  # noqa: F401  (re-export)


def topk_lastdim(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (values, int32 indices) over the last dimension."""
    n = x.shape[-1]
    canon = k == 1 or (x.dtype == torch.bfloat16 and k < n <= 32768)
    return _ktopk.topk(x, k, canon_zero=canon)


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
