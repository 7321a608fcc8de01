"""Depthwise 7x7 conv (pad 3, stride 1) + bias + SiLU: CUDA kernel (csrc/dw7x7.cu)
and plain version.

The folded RepVGGDW block (`leanyolo_tpu/models/yolov10/layers.py:359-361`).
Replaces the JAX package's Pallas kernel `experiments/exp_dw_pallas.py:75
dw_pallas`, for any B, H, W, C. Rounding follows the folded JAX forward: the
fp32 sum is rounded to the activation dtype, then the bias add and the SiLU
each round again.

Both versions take the weights packed once as [49, C] (`pack_weights`: a
tap's channels contiguous, the layout the kernel reads), as
`layers.FusedRepVGGDW` holds them. The wrapper is the operator
`leanyolo_tpu_torch::dw7x7_bias_silu` (_build.operator).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES
from ._build import check_cuda, ext, operator


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """[C, 1, 7, 7] depthwise weights -> [49, C], contiguous."""
    return w.reshape(w.shape[0], 49).t().contiguous()


def dw7x7_bias_silu_plain(x: torch.Tensor, w49: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] NHWC, w49 [49, C], b [C] -> [B, H, W, C] in x's dtype."""
    c = x.shape[-1]
    w = w49.t().reshape(c, 1, 7, 7)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None, 1, 3, 1, c)
    return F.silu(y + b.to(y.dtype).view(1, -1, 1, 1)).permute(0, 2, 3, 1)


def _dw7x7_cpu(x: torch.Tensor, w49: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return dw7x7_bias_silu_plain(x, w49, b).contiguous()


def _dw7x7_fake(x: torch.Tensor, w49: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return x.new_empty(x.shape)


def _dw7x7_cuda(x: torch.Tensor, w49: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    check_cuda(x, "dw7x7 x")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 4:
        raise ValueError(f"dw7x7: bf16 or fp32 NHWC input, got {x.dtype} {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(w49.shape) != (49, c) or tuple(b.shape) != (c,):
        raise ValueError(f"dw7x7: need w49 [49, {c}] and b [{c}], got {tuple(w49.shape)}, {tuple(b.shape)}")
    wk = w49.to(x.dtype).contiguous()  # no copy for weights packed in x's dtype
    bk = b.to(x.dtype).contiguous()
    check_cuda(wk, "dw7x7 w")
    check_cuda(bk, "dw7x7 b")
    out = torch.empty_like(x)
    if x.numel():
        ext().dw7x7(x, wk, bk, out)
        LAUNCHES["dw7x7"] += 1
    return out


_DW7X7 = operator("dw7x7_bias_silu", "(Tensor x, Tensor w49, Tensor b) -> Tensor", cpu=_dw7x7_cpu,
                  cuda=_dw7x7_cuda, fake=_dw7x7_fake)


def dw7x7_bias_silu(x: torch.Tensor, w49: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C] NHWC (contiguous on the card), w49 [49, C], b [C],
    through the operator `leanyolo_tpu_torch::dw7x7_bias_silu`."""
    return _DW7X7(x, w49, b)
