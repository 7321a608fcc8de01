"""The model's floating-point operations an image, counted from the
configuration's layer shapes (the plain reference model run on the meta
device, which computes shapes and no values).

Counted: every convolution, 2 x Cout x Cin/groups x k x k x Hout x Wout (a
multiply and an add a weight a position), and PSA's two attention
products, 2 x heads x n x n x (key_dim + head_dim) for n positions. Not
counted: BN, activations, adds, pooling, the softmax, the decode: they are
memory-bound and few in operations.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def forward_flops(cfg: dict, imgsz: int, branches: Sequence[str] = ("one2one",)) -> Dict[str, int]:
    """{'conv': ..., 'attention': ..., 'total': ...} operations of one image's
    forward through the backbone, the neck and the head's `branches`."""
    from ..reference.model import Attention, Conv, YOLOv10

    counts = {"conv": 0, "attention": 0}

    def conv_hook(mod, args, out):
        w = mod.weight
        counts["conv"] += 2 * w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3] * out.shape[2] * out.shape[3]

    def attn_hook(mod, args, out):
        n = out.shape[2] * out.shape[3]
        counts["attention"] += 2 * mod.nh * n * n * (mod.kd + mod.hd)

    with torch.device("meta"):
        model = YOLOv10(cfg)
    model.eval()
    handles = [m.register_forward_hook(conv_hook) for m in model.modules() if isinstance(m, Conv)]
    handles += [m.register_forward_hook(attn_hook) for m in model.modules() if isinstance(m, Attention)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, imgsz, imgsz, 3, device="meta"), branches=tuple(branches))
    finally:
        for h in handles:
            h.remove()
    counts["total"] = counts["conv"] + counts["attention"]
    return counts


def serve_flops(cfg: dict, imgsz: int) -> int:
    """Operations of one served image: the one2one branch only."""
    return forward_flops(cfg, imgsz, ("one2one",))["total"]


def train_flops(cfg: dict, imgsz: int) -> int:
    """Operations of one trained image: three times the forward through both
    head branches (the backward takes twice the forward's products)."""
    return 3 * forward_flops(cfg, imgsz, ("one2many", "one2one"))["total"]
