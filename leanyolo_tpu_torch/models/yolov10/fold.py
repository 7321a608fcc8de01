"""Inference-time folding: BN -> conv bias, RepVGGDW -> one 7x7 conv, input
normalization -> stem conv, then an optional cast of every float tensor.

Counterpart of the JAX package's `leanyolo_tpu/models/yolov10/fold.py:29-131`.
All folding math runs in fp32 on the CPU before the cast, as there:

1. conv-BN: w' = w * gamma / sqrt(var + eps) per output channel,
   b' = beta - mean * gamma / sqrt(var + eps) (+ conv bias * the same factor);
2. RepVGGDW: both branches BN-folded, the 3x3 kernel zero-padded to 7x7 and
   summed into the 7x7 one, biases summed;
3. normalization: conv((x - sub) / div, w) + b == conv(x, w / div)
   + (b - sum(w * sub / div)), and the buffers become identity.

The folded model holds `FusedRepVGGDW` modules and folded `ConvBNAct`s
(bias, no BN), which route through the fused-stem and dw7x7 kernels. Then
each dense 1x1 stride-1 conv (in a `ConvBNAct` or the head's biased `Conv`)
becomes a `MatmulConv` (bmm kernel) and each dense 3x3 stride-1 32 -> 32
`ConvBNAct` with SiLU an `S2DConvBNAct` (s2dconv kernel), their weights
packed once, as are the stem's (`Backbone.pack`, after the normalization
fold). Unfolded and training models keep cuDNN.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L
from .model import YOLOv10


def _folded_conv_bn(m: L.ConvBNAct) -> Tuple[torch.Tensor, torch.Tensor]:
    w = m.conv.weight.detach().float().cpu()
    bn = m.bn
    mul = bn.weight.detach().float().cpu() / torch.sqrt(bn.running_var.float().cpu() + L.BN_EPS)
    b = bn.bias.detach().float().cpu() - bn.running_mean.float().cpu() * mul
    if m.conv.bias is not None:
        b = b + m.conv.bias.detach().float().cpu() * mul
    return w * mul[:, None, None, None], b


def _fuse_repvggdw(m: L.RepVGGDW) -> L.FusedRepVGGDW:
    w7, b7 = _folded_conv_bn(m.conv)
    w3, b3 = _folded_conv_bn(m.conv1)
    return L.FusedRepVGGDW(w7.shape[0], w7 + F.pad(w3, (2, 2, 2, 2)), b7 + b3)


def _set_submodule(root: nn.Module, name: str, new: nn.Module) -> None:
    parent_name, _, leaf = name.rpartition(".")
    setattr(root.get_submodule(parent_name) if parent_name else root, leaf, new)


def fold_module(module: nn.Module) -> nn.Module:
    """A copy of any module tree with BN folded into the convs and each
    RepVGGDW fused (the module itself is untouched; folding twice changes
    nothing)."""
    out = copy.deepcopy(module).cpu()
    if type(out) is L.RepVGGDW:
        return _fuse_repvggdw(out)
    for name, m in list(out.named_modules()):
        if type(m) is L.RepVGGDW:
            _set_submodule(out, name, _fuse_repvggdw(m))
    for m in out.modules():
        if isinstance(m, L.ConvBNAct) and m.bn is not None:
            w, b = _folded_conv_bn(m)
            m.conv.weight = nn.Parameter(w)
            m.conv.bias = nn.Parameter(b)
            m.bn = None
    return _route_kernels(out)


def _dense(conv: L.Conv, k: int) -> bool:
    return (tuple(conv.weight.shape[2:]) == (k, k) and conv.stride == 1 and conv.groups == 1
            and conv.padding == k // 2)


def _kernel_module(m: nn.Module) -> Optional[nn.Module]:
    """The kernel-backed replacement of a folded module, or None."""
    if type(m) is L.Conv and _dense(m, 1):
        return L.MatmulConv(m)
    if (type(m) is L.ConvBNAct and m.folded and m.act and _dense(m.conv, 3) and m.conv.bias is not None
            and tuple(m.conv.weight.shape[:2]) == (32, 32)):
        return L.S2DConvBNAct(m.conv)
    return None


def _route_kernels(root: nn.Module) -> nn.Module:
    new = _kernel_module(root)
    if new is not None:
        return new  # a replacement holds no module that is replaced in turn
    for name, m in list(root.named_modules()):
        new = _kernel_module(m) if name else None
        if new is not None:
            _set_submodule(root, name, new)
    return root


def fold_model(model: YOLOv10, *, dtype: Optional[torch.dtype] = None) -> YOLOv10:
    """A folded copy of `model` for serving (JAX `fold_params`).

    `dtype` (e.g. torch.bfloat16) casts every float parameter and buffer
    after folding.
    """
    out = fold_module(model)
    _fold_norm_into_stem(out)
    out.backbone.pack()
    if dtype is not None:
        out = out.to(dtype)
    return out


def _fold_norm_into_stem(model: YOLOv10) -> None:
    sub = model.input_subtract.float()
    div = model.input_divide.float()
    if bool(torch.all(sub == 0.0)) and bool(torch.all(div == 1.0)):
        return
    conv = model.backbone.cv0.conv
    w = conv.weight.detach().float()  # [cout, cin, kh, kw]
    b = conv.bias.detach().float() if conv.bias is not None else torch.zeros(w.shape[0])
    conv.weight = nn.Parameter(w / div[None, :, None, None])
    conv.bias = nn.Parameter(b - torch.einsum("oihw,i->o", w, sub / div))
    model.input_subtract = torch.zeros_like(sub)
    model.input_divide = torch.ones_like(div)
