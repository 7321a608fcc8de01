"""Matrix product [B, M, K] x [K, N] with an fp32 sum: CUDA kernel
(csrc/matmul.cu) and plain version.

Every dense 1x1 stride-1 conv of the folded model runs through it on the
NHWC view of its input (M = H*W). Replaces the JAX package's Pallas kernel
`experiments/exp_pallas_mm.py:40 pallas_mm`, for any B, M, K and N. The
products are summed in fp32 and rounded once to the input's dtype, where
the folded JAX forward rounds a conv's output, before its bias.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check_cuda, ext


def bmm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, M, K], w [K, N] -> [B, M, N] in x's dtype (fp32 sum)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _row_stride(x: torch.Tensor):
    """The stride between the B*M rows of x [B, M, K] when they are evenly
    spaced with unit stride in K (a channel slice of an NHWC map), else None."""
    b, m, k = x.shape
    if x.stride(2) != 1:
        return None
    lda = x.stride(1) if m > 1 else x.stride(0)
    if b > 1 and m > 1 and x.stride(0) != m * lda:
        return None
    return lda if lda >= k else None


def bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, M, K] (rows read in place where evenly strided), w [K, N] ->
    [B, M, N] contiguous, in x's dtype."""
    if x.device.type == "cpu":
        return bmm_plain(x, w)
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 3 or w.ndim != 2 or w.shape[0] != x.shape[2]:
        raise ValueError(f"bmm: bf16 or fp32 x [B, M, K] and w [K, N], got {x.dtype} {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"bmm: expected a CUDA tensor, got one on {x.device}")
    lda = _row_stride(x)
    if lda is None:
        x = x.contiguous()
        lda = x.shape[2]
    wk = w.to(x.dtype).contiguous()
    check_cuda(wk, "bmm w")
    b, m, _ = x.shape
    out = torch.empty(b, m, wk.shape[1], dtype=x.dtype, device=x.device)
    if out.numel():
        ext().bmm(x, wk, out, b * m, lda)
        LAUNCHES["bmm"] += 1
    return out
