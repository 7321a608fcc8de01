"""Tensor parallelism: each layer's output channels split over a mesh's `model` axis.

Counterpart of the JAX package's `tp_shard_params`
(`leanyolo_tpu/parallel/mesh.py:115-138`) and of the channel sharding GSPMD
threads through its network. The leaf rule is JAX's: a conv whose output
channels O divide by the model axis's size n keeps on each rank its slice
of O/n filters, with the slices of its bias and BN vectors; every other conv
stays whole.

The design is column parallel: a sliced layer computes its slice of the
output channels from the whole input (a depthwise one from its slice of the
input, with no communication for that), applies its epilogue to the slice
and all-gathers the slices along channels over the model group, so every
layer reads the whole map. JAX instead contracts sharded inputs locally and
psums the partial sums. Column parallelism was chosen because it keeps each
output's arithmetic that of one process (the same products summed in the
same fp32 accumulator by the same kernel), so the card's bf16 results hold
close to the one-process predictor's; its cost is an all-gather after every
sliced layer where a psum would come after every contraction.

Layers that run whole on every rank, whatever O is, because their kernels
are compiled for fixed widths (`kept_whole`): the fused stem (backbone cv0 and
cv1: its tensor-core route is built per (c0, c1) of the six sizes, and
conv1 contracts every channel of conv0 inside the kernel) and the dense 3x3
32 -> 32 convs of the s2dconv kernel. bmm takes any slice width (the wgmma
route for K and N multiples of 8, mma.sync for the rest) and dw7x7 any C.
`tp_shard_params` records which layers it split and which it kept whole
(`module.tp_plan`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from ..models.yolov10 import layers as L
from .spatial import all_gather

def _layers(module: nn.Module) -> List[Tuple[str, nn.Module]]:
    """Every conv layer of `module`: the ConvBNActs, and the bare convs
    that are not the conv of a ConvBNAct (the head's last 1x1 convs)."""
    owned = {id(m.conv) for m in module.modules() if isinstance(m, L.ConvBNAct)}
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, L.ConvBNAct) or (isinstance(m, L.Conv) and id(m) not in owned)]


def _conv_of(layer: nn.Module) -> L.Conv:
    return layer.conv if isinstance(layer, L.ConvBNAct) else layer


def kept_whole(name: str, layer: nn.Module) -> bool:
    """A layer that runs whole (module doc): the stem's two convs, or a dense
    3x3 stride-1 32 -> 32 conv + SiLU (folded or not: the s2dconv kernel's)."""
    if name in ("backbone.cv0", "backbone.cv1"):
        return True
    if isinstance(layer, L.S2DConvBNAct):
        return True
    conv = _conv_of(layer)
    return (isinstance(layer, L.ConvBNAct) and layer.act and tuple(conv.weight.shape) == (32, 32, 3, 3)
            and conv.stride == 1 and conv.groups == 1)


@torch.no_grad()
def _slice(layer: nn.Module, n: int, index: int) -> None:
    conv = _conv_of(layer)
    o = conv.weight.shape[0]
    sl = slice(index * o // n, (index + 1) * o // n)
    depthwise = conv.groups > 1
    if depthwise and not (conv.groups == o and conv.weight.shape[1] == 1):
        raise ValueError(f"tensor parallelism slices depthwise or dense convs, not groups={conv.groups} of {o}")
    conv.weight = nn.Parameter(conv.weight[sl].clone())
    if conv.bias is not None:
        conv.bias = nn.Parameter(conv.bias[sl].clone())
    bn = getattr(layer, "bn", None)
    if bn is not None:
        bn.weight = nn.Parameter(bn.weight[sl].clone())
        bn.bias = nn.Parameter(bn.bias[sl].clone())
        bn.running_mean = bn.running_mean[sl].clone()
        bn.running_var = bn.running_var[sl].clone()
    if depthwise:
        conv.groups, conv.channels = o // n, sl
    layer.tp_split = (n, index)
    for m in (layer, conv):
        if hasattr(m, "pack"):
            m.pack()  # bmm's wt, dw7x7's w49, packed again from the slice


def tp_shard_params(mesh, module: nn.Module) -> nn.Module:
    """Slice `module` in place for this rank of the mesh's `model` axis
    (module doc) and return it; `module.tp_plan` = {"split": [names],
    "whole": [names]}. Works on an unfolded or a folded YOLOv10 (the
    folded layers' packed kernel weights are packed again)."""
    from .mesh import MODEL_AXIS, axis_coordinate

    return shard_layers(module, *axis_coordinate(mesh, MODEL_AXIS))


def shard_layers(module: nn.Module, n: int, index: int) -> nn.Module:
    """`tp_shard_params` for rank `index` of n, without a mesh."""
    plan: Dict[str, list] = {"split": [], "whole": []}
    for name, layer in _layers(module):
        o = _conv_of(layer).weight.shape[0]
        if n == 1 or layer.tp_split is not None:
            continue
        if kept_whole(name, layer) or o % n or o < n:
            plan["whole"].append(name)
            continue
        _slice(layer, n, index)
        plan["split"].append(name)
    module.tp_plan = plan
    return module


class Channels:
    """A model group as the layers use it (`layers.split_forward`): the
    process group the sliced layers gather their output channels over, and
    `traffic`, the bytes this rank received in those gathers, by kind, as
    `spatial.Space` counts its own. `exchange(t)`, when given, stands in for
    the all-gather (ranks as threads of one process), as in `Space`."""

    def __init__(self, group, exchange=None) -> None:
        self.group, self.exchange = group, exchange
        self.traffic = {"channels": 0}

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """[B, C/n, H, W] slices from every rank of the group -> [B, C, H, W]
        (channels_last memory, as the card's maps are)."""
        part = y.permute(0, 2, 3, 1).contiguous()  # NHWC: a slice is a run of channels a pixel
        got = self.exchange(part) if self.exchange is not None else all_gather(part, self.group)
        self.traffic["channels"] += (len(got) - 1) * part.numel() * part.element_size()
        return torch.cat(got, dim=-1).permute(0, 3, 1, 2)
