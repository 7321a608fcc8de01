"""Fused stem: CUDA kernel (csrc/stem.cu) and plain version.

Computes backbone cv0 + cv1 of the folded model, the two 3x3 stride-2
conv + bias + SiLU, on raw NHWC images, with the input normalization
already folded into conv0's weights. Replaces the JAX package's Pallas
kernels `experiments/stem_pallas.py:254 fused_stem` and
`:204 fused_stem_v2` (the same function in two layouts).

Rounding follows the folded JAX forward: each conv's fp32 sum is rounded to
the activation dtype, the bias is added and rounded, the SiLU is applied and
rounded. The kernel keeps the conv0 activations in shared memory, so they
never go to device memory.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import LAUNCHES
from ._build import check_cuda, ext

# (conv0, conv1) output widths the kernel is compiled for: yolov10n, yolov10s.
WIDTHS = ((16, 32), (32, 64))


def _conv_bias_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x, w.to(x.dtype), None, 2, 1)
    return F.silu(y + b.to(y.dtype).view(1, -1, 1, 1))


def fused_stem_plain(images, w0, b0, w1, b1, *, dtype: torch.dtype) -> torch.Tensor:
    """images [B, H, W, 3] (uint8 or float) -> [B, H/4, W/4, c1] NHWC in `dtype`."""
    x = images.to(dtype).permute(0, 3, 1, 2)
    return _conv_bias_silu(_conv_bias_silu(x, w0, b0), w1, b1).permute(0, 2, 3, 1)


def fused_stem(images, w0, b0, w1, b1, *, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Folded cv0+cv1: images [B, H, W, 3] NHWC, w0 [c0, 3, 3, 3], b0 [c0],
    w1 [c1, c0, 3, 3], b1 [c1] -> [B, H/4, W/4, c1] NHWC in `dtype`
    (default: w0's dtype). On the card H and W must be multiples of 32."""
    dtype = w0.dtype if dtype is None else dtype
    if images.device.type == "cpu":
        return fused_stem_plain(images, w0, b0, w1, b1, dtype=dtype)
    check_cuda(images, "fused_stem images")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_stem: bf16 or fp32 activations, got {dtype}")
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"fused_stem: images must be [B, H, W, 3], got {tuple(images.shape)}")
    b, h, w, _ = images.shape
    if h % 32 or w % 32:
        raise ValueError(f"fused_stem: H and W must be multiples of 32, got {h}x{w}")
    c0, c1 = w0.shape[0], w1.shape[0]
    if (c0, c1) not in WIDTHS or tuple(w0.shape) != (c0, 3, 3, 3) or tuple(w1.shape) != (c1, c0, 3, 3):
        raise ValueError(f"fused_stem: kernel built for (c0, c1) in {WIDTHS} with 3x3 kernels, "
                         f"got w0 {tuple(w0.shape)}, w1 {tuple(w1.shape)}")
    if images.dtype != torch.uint8:
        images = images.to(dtype)
    # HWIO weights: the kernel reads one tap's output channels contiguously.
    w0k = w0.to(dtype).permute(2, 3, 1, 0).contiguous()
    w1k = w1.to(dtype).permute(2, 3, 1, 0).contiguous()
    b0k, b1k = b0.to(dtype).contiguous(), b1.to(dtype).contiguous()
    for t, name in ((w0k, "w0"), (w1k, "w1"), (b0k, "b0"), (b1k, "b1")):
        check_cuda(t, f"fused_stem {name}")
    out = torch.empty(b, h // 4, w // 4, c1, dtype=dtype, device=images.device)
    if b:
        ext().stem(images, w0k, b0k, w1k, b1k, out)
        LAUNCHES["stem"] += 1
    return out
