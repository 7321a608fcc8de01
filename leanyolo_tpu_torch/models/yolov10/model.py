"""YOLOv10 model graph: backbone -> PAN neck -> dual detection head.

Counterpart of the JAX package's `leanyolo_tpu/models/yolov10/model.py:59-340`,
node for node. `YOLOv10.forward` mirrors `model_apply`: it takes NHWC images
and returns NHWC head maps per branch, so both packages are compared like
for like. Inside, activations are NCHW tensors in `channels_last` memory.

Parameters carry across from a JAX tree by name (convert.py); the seeded init
here uses an explicit `torch.Generator` and does not reproduce JAX's random
numbers.
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ...kernels import stem
from . import layers as L
from .config import VARIANTS, VariantCfg

Tensor = torch.Tensor


def _c2f(cfg: VariantCfg, node: str, c_in: int, c_out: int, n: int, *, c2f_shortcut: bool, lk: bool, g) -> L.C2f:
    """A C2f or C2fCIB node, by the variant's block-type switch."""
    if cfg.types.get(node, "C2f") == "C2fCIB":
        return L.C2f(c_in, c_out, n, shortcut=True, lk=lk, generator=g)
    return L.C2f(c_in, c_out, n, shortcut=c2f_shortcut, generator=g)


class Backbone(nn.Module):
    """11-node backbone; returns (C3, C4, C5) at strides (8, 16, 32)."""

    def __init__(self, cfg: VariantCfg, in_channels: int = 3, generator=None) -> None:
        super().__init__()
        ch, reps, g = cfg.ch, cfg.reps, generator
        self.cv0 = L.ConvBNAct(in_channels, ch[0], 3, stride=2, generator=g)
        self.cv1 = L.ConvBNAct(ch[0], ch[1], 3, stride=2, generator=g)
        self.c2 = L.C2f(ch[1], ch[2], reps.get(2, 1), shortcut=True, generator=g)
        self.cv3 = L.ConvBNAct(ch[2], ch[3], 3, stride=2, generator=g)
        self.c4 = L.C2f(ch[3], ch[4], reps.get(4, 1), shortcut=True, generator=g)
        self.sc5 = L.SCDown(ch[4], ch[5], generator=g)
        self.c6 = _c2f(cfg, "c6", ch[5], ch[6], reps.get(6, 1), c2f_shortcut=True, lk=False, g=g)
        self.sc7 = L.SCDown(ch[6], ch[7], generator=g)
        self.c8 = _c2f(cfg, "c8", ch[7], ch[8], reps.get(8, 1), c2f_shortcut=True, lk=cfg.use_lk_c8, g=g)
        self.sppf9 = L.SPPF(ch[8], ch[9], generator=g)
        self.psa10 = L.PSA(ch[9], generator=g)
        # The folded stem's weights as the tensor-core kernel reads them
        # (stem.pack_weights): packed by fold.py once, and again after a
        # state-dict load, out of the state dict.
        self.register_buffer("stem_w0p", None, persistent=False)
        self.register_buffer("stem_w1p", None, persistent=False)
        self.register_load_state_dict_post_hook(L._repack)

    def pack(self) -> None:
        with torch.no_grad():
            folded = self.cv0.folded and self.cv1.folded
            self.stem_w0p, self.stem_w1p = (stem.pack_weights(self.cv0.conv.weight, self.cv1.conv.weight)
                                            if folded else (None, None))

    def stem(self, images: Tensor, dtype: torch.dtype) -> Tensor:
        """cv0 + cv1 on NHWC images -> NCHW stride-4 features.

        Folded, both convs run as one fused-stem kernel (kernels/stem.py) that
        reads the raw images; unfolded, as two conv->BN->SiLU blocks.

        On a band of image rows (layers.split_forward) the kernel reads the
        4 rows above (none at the image's top, where its own zero padding is
        the image's: conv1 pads conv0's output with 0, which conv0 on rows
        of 0 would not give), the band, and rows of 0 up to a multiple of 32;
        the output rows the halo and the padding made are cropped.
        """
        if self.cv0.folded and self.cv1.folded:
            sp, _ = L._split_space()
            x, above = images, 0
            if sp is not None:
                lo, _ = sp.plan.band(1, sp.pos)
                above = min(4, lo)
                x = sp.halo(images, 1, 4, 0, None, dim=1)
                pad = -x.shape[1] % 32
                x = torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))], 1)  # contiguous, as the kernel reads it
                L._moved(4)
            y = stem.fused_stem(x, self.cv0.conv.weight, self.cv0.conv.bias, self.cv1.conv.weight,
                                self.cv1.conv.bias, dtype=dtype, packed=(self.stem_w0p, self.stem_w1p))
            if sp is not None:
                y = y[:, above // 4: above // 4 + images.shape[1] // 4]
            return y.permute(0, 3, 1, 2)
        x = images.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.cv1(self.cv0(x))

    def forward(self, images: Tensor, dtype: torch.dtype, remat: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
        seg = functools.partial(L.node, remat)  # each node (at the stride it reads) a checkpoint segment when remat
        x = seg(4, self.c2, seg(1, self.stem, images, dtype))
        c3 = seg(8, self.c4, seg(4, self.cv3, x))
        c4 = seg(16, self.c6, seg(8, self.sc5, c3))
        x = seg(32, self.c8, seg(16, self.sc7, c4))
        c5 = seg(32, self.psa10, seg(32, self.sppf9, x))
        return c3, c4, c5


class Neck(nn.Module):
    """PAN-FPN: top-down merges (upsample-concat tuples) then bottom-up."""

    def __init__(self, cfg: VariantCfg, generator=None) -> None:
        super().__init__()
        c3, c4, c5 = cfg.backbone_out
        hch, reps, g = cfg.hch, cfg.reps, generator
        # Plain-C2f merges use shortcut=False; C2fCIB merges shortcut=True.
        self.p5_p4_c2f = _c2f(cfg, "p5_p4", c5 + c4, hch[13], reps.get(13, 1), c2f_shortcut=False,
                              lk=cfg.use_lk_p5_p4, g=g)
        self.p4_p3_c2f = L.C2f(hch[13] + c3, hch[16], reps.get(16, 1), shortcut=False, generator=g)
        self.p3_down = L.ConvBNAct(hch[16], hch[16], 3, stride=2, generator=g)
        self.p3_p4_c2f = _c2f(cfg, "p3_p4", hch[16] + hch[13], hch[19], reps.get(19, 1), c2f_shortcut=False,
                              lk=False, g=g)
        self.p4_down = L.SCDown(hch[19], hch[19], generator=g)
        self.p4_p5_c2f = L.C2f(hch[19] + c5, hch[22], reps.get(22, 1), shortcut=True, lk=cfg.use_lk_p4_p5,
                               generator=g)

    def forward(self, c3: Tensor, c4: Tensor, c5: Tensor, remat: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
        seg = functools.partial(L.node, remat)
        p4 = seg(16, self.p5_p4_c2f, (c5, c4))
        p3 = seg(8, self.p4_p3_c2f, (p4, c3))
        p4 = seg(16, self.p3_p4_c2f, L._cat((seg(8, self.p3_down, p3), p4)))
        p5 = seg(32, self.p4_p5_c2f, L._cat((seg(16, self.p4_down, p4), c5)))
        return p3, p4, p5


def head_branch_channels(nc: int, ch: Sequence[int], reg_max: int) -> Tuple[int, int]:
    """(c2, c3) intermediate widths of the reg and cls branches."""
    return max(16, ch[0] // 4, reg_max * 4), max(ch[0], min(nc, 100))


def _reg_branch(c_in: int, c2: int, reg_max: int, g) -> nn.Sequential:
    return nn.Sequential(
        L.ConvBNAct(c_in, c2, 3, generator=g),
        L.ConvBNAct(c2, c2, 3, generator=g),
        L.Conv(c2, 4 * reg_max, 1, bias=True, generator=g),
    )


def _cls_branch(c_in: int, c3: int, nc: int, g) -> nn.Sequential:
    return nn.Sequential(
        nn.Sequential(L.ConvBNAct(c_in, c_in, 3, groups=c_in, generator=g), L.ConvBNAct(c_in, c3, 1, generator=g)),
        nn.Sequential(L.ConvBNAct(c3, c3, 3, groups=c3, generator=g), L.ConvBNAct(c3, c3, 1, generator=g)),
        L.Conv(c3, nc, 1, bias=True, generator=g),
    )


class Head(nn.Module):
    """Dual detection head: one2many (`cv2`/`cv3`) and one2one branches.

    The one2one branches start as exact copies of the one2many ones.
    """

    def __init__(self, nc: int, ch: Sequence[int], reg_max: int = 16, generator=None) -> None:
        super().__init__()
        c2, c3 = head_branch_channels(nc, ch, reg_max)
        self.cv2 = nn.ModuleList()
        self.cv3 = nn.ModuleList()
        for c_in in ch:
            self.cv2.append(_reg_branch(c_in, c2, reg_max, generator))
            self.cv3.append(_cls_branch(c_in, c3, nc, generator))
        self.one2one_cv2 = copy.deepcopy(self.cv2)
        self.one2one_cv3 = copy.deepcopy(self.cv3)

    def forward(self, feats: Sequence[Tensor], *, branch: str, concat: bool = True) -> List:
        """Per level NHWC [B, H, W, 4*reg_max + nc], or (reg, cls) NHWC tuples
        with concat=False."""
        if branch == "one2many":
            cv2, cv3 = self.cv2, self.cv3
        elif branch == "one2one":
            cv2, cv3 = self.one2one_cv2, self.one2one_cv3
        else:
            raise ValueError(f"unknown head branch: {branch}")
        out = []
        for i, (reg_m, cls_m, x) in enumerate(zip(cv2, cv3, feats)):
            r = L.node(False, 8 << i, reg_m, x).permute(0, 2, 3, 1)
            c = L.node(False, 8 << i, cls_m, x).permute(0, 2, 3, 1)
            out.append(torch.cat([r, c], dim=-1) if concat else (r, c))
        return out


def reset_head(model: "YOLOv10", seed: int) -> None:
    """Replace `model.head`, in place and on the model's device, by a fresh
    head (JAX `head_init`, the training CLIs' --head-reset): every leaf drawn
    anew from a CPU generator seeded with `seed + 1`, the one2one branches
    exact copies of the one2many ones. The draws are the port's init, not
    JAX's PRNG stream."""
    p = next(model.parameters())
    head = Head(model.nc, model.cfg.neck_out, model.cfg.reg_max, generator=torch.Generator().manual_seed(seed + 1))
    model.head = head.to(p.device).train(model.training)


class YOLOv10(nn.Module):
    """Normalize -> backbone -> neck -> head.

    Holds the variant config, the class names and the input normalization
    buffers beside the modules, as the JAX `YOLOv10` wrapper holds them.
    """

    def __init__(self, cfg: VariantCfg, class_names: Sequence[str], *, in_channels: int = 3,
                 input_norm_subtract=(0.0, 0.0, 0.0), input_norm_divide=(255.0, 255.0, 255.0),
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.class_names = list(class_names)
        g = generator
        self.backbone = Backbone(cfg, in_channels, generator=g)
        self.neck = Neck(cfg, generator=g)
        self.head = Head(self.nc, cfg.neck_out, cfg.reg_max, generator=g)
        self.register_buffer("input_subtract", torch.tensor(input_norm_subtract, dtype=torch.float32).reshape(in_channels))
        self.register_buffer("input_divide", torch.tensor(input_norm_divide, dtype=torch.float32).reshape(in_channels))

    @property
    def nc(self) -> int:
        return len(self.class_names)

    @classmethod
    def create(cls, name: str, *, class_names: Sequence[str], seed: int = 0, **kw) -> "YOLOv10":
        """Seeded random init of variant `name` on the CPU."""
        return cls(VARIANTS[name], class_names, generator=torch.Generator().manual_seed(seed), **kw)

    def forward(
        self,
        images: Tensor,
        *,
        dtype: Optional[torch.dtype] = None,
        branches: Tuple[str, ...] = ("one2many", "one2one"),
        normalize: bool = True,
        concat_head: bool = True,
        remat: bool = False,
    ) -> Dict[str, List]:
        """images: [B, H, W, C] NHWC, raw pixels (uint8 or float).

        dtype: compute dtype (default: the images' float dtype, else fp32).
        normalize: False when the normalization is folded into conv0 (fold.py).
        concat_head: False returns per-level (reg, cls) NHWC tuples.
        remat: activation checkpointing (the trainer's remat="full"): each
        backbone and neck node and each head branch is a checkpoint segment.
        Returns {branch: [P3, P4, P5]} NHWC maps.

        In training mode (`.train()`) every BN normalizes with its batch's
        statistics; the trainer takes both branches as (reg, cls) tuples.
        Neither branch is detached: the JAX `model_apply` stops no gradient
        at the one2one head (the official YOLOv10 does), and the port
        follows the JAX package.
        """
        if dtype is None:
            dtype = images.dtype if images.is_floating_point() else torch.float32
        x = images
        if normalize:
            x = (x.to(dtype) - self.input_subtract.to(dtype)) / self.input_divide.to(dtype)
        c3, c4, c5 = self.backbone(x, dtype, remat)
        p3, p4, p5 = self.neck(c3, c4, c5, remat)
        return {b: L.segment(remat, self.head, (p3, p4, p5), branch=b, concat=concat_head) for b in branches}
