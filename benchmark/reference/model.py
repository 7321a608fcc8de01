"""Plain float32 YOLOv10 (backbone, PAN neck, dual head), built from a
configuration file of the benchmark (`configs/<name>.json`).

Written for the benchmark in plain PyTorch: no kernel, no fused or folded
form, no batching trick. It follows the published YOLOv10 graph
(THU-MIG/yolov10, `ultralytics/nn/modules/block.py`: C2f, C2fCIB, CIB,
RepVGGDW, SCDown, SPPF, PSA, Attention; `head.py`: v10Detect) with these
departures, which are the system's definition of the model and not the
paper's:

- BatchNorm eps is 1e-3 (`bn_eps` in the configuration);
- neither head branch is detached from the neck in training (the published
  v10Detect detaches the one2one branch's input);
- inputs are NHWC raw pixels, divided by 255 inside the model.

Parameter and buffer names match the system's module tree (`backbone.c2.m.0
.cv1.conv.weight`, `head.one2one_cv3.2.2.bias`, ...), so one state dict loads
into both.

Modes: `eval()` normalizes with the running statistics; `train()` with the
batch's (biased variance) and leaves the running statistics alone;
`calibrate(images)` sets every running statistic to the batch statistics of
`images`, layer by layer. `quant="fp8"` rounds to float8 e4m3, each at a
per-tensor scale, every convolution's input and weight and what each
conv -> BN -> SiLU block stores after each of its three steps, as a bf16
path rounds to bf16 there, and their gradients on the way back (the
control of a lower precision); `checkpoint=True` recomputes each node in the backward.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

Tensor = torch.Tensor
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def _round_fp8(x: Tensor) -> Tensor:
    scale = x.abs().amax().clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _FakeFP8(torch.autograd.Function):
    """x rounded to float8 e4m3 at a per-tensor scale (amax -> 448), and its
    gradient rounded the same way on the way back."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        return _round_fp8(g)


def fake_fp8(x: Tensor) -> Tensor:
    return _FakeFP8.apply(x)


class Conv(nn.Module):
    """2D conv, OIHW weight, optional bias, k // 2 padding."""

    def __init__(self, c_in: int, c_out: int, k: int, *, stride: int = 1, groups: int = 1,
                 padding: Optional[int] = None, bias: bool = False) -> None:
        super().__init__()
        self.stride, self.groups = stride, groups
        self.padding = k // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.empty(c_out, c_in // groups, k, k))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None
        self.quant: Optional[str] = None

    def forward(self, x: Tensor, weight: Optional[Tensor] = None, bias: Optional[Tensor] = None) -> Tensor:
        """The conv of x with its own weight and bias, or with `weight` and
        `bias` in their place (a folded BN)."""
        if weight is None:
            weight, bias = self.weight, self.bias
        if self.quant == "fp8":
            x, weight = fake_fp8(x), fake_fp8(weight)
        return F.conv2d(x, weight, bias, self.stride, self.padding, 1, self.groups)


class BatchNorm(nn.Module):
    def __init__(self, c: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.calibrating = False
        self.record = False  # keep the batch variance of the next training forward in `.batch_var`
        self.batch_var: Optional[Tensor] = None
        self.batch_count = 0

    def stats(self, y: Tensor) -> Tuple[Tensor, Tensor]:
        """(mean, var) the layer normalizes with, per channel."""
        if self.training or self.calibrating:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
            if self.record:
                self.batch_var = var.detach().clone()
                self.batch_count = y.numel() // y.shape[1]
            if self.calibrating:
                with torch.no_grad():
                    self.running_mean.copy_(mean)
                    self.running_var.copy_(var)
            return mean, var
        return self.running_mean, self.running_var

    def scale_shift(self, y: Tensor) -> Tuple[Tensor, Tensor]:
        mean, var = self.stats(y)
        mul = self.weight / torch.sqrt(var + self.eps)
        return mul, self.bias - mean * mul


class ConvBNAct(nn.Module):
    """conv -> BN -> SiLU (or no activation). In eval mode the BN runs as the
    conv's folded weight and bias, which is the same function, so the fp8
    control rounds the weight a folded deployment would hold."""

    def __init__(self, c_in: int, c_out: int, k: int, eps: float, *, stride: int = 1, groups: int = 1,
                 padding: Optional[int] = None, act: bool = True) -> None:
        super().__init__()
        self.conv = Conv(c_in, c_out, k, stride=stride, groups=groups, padding=padding)
        self.bn = BatchNorm(c_out, eps)
        self.act = act

    def forward(self, x: Tensor) -> Tensor:
        q = fake_fp8 if self.conv.quant == "fp8" else (lambda t: t)
        if self.bn.training or self.bn.calibrating:
            y = q(self.conv(x))
            mul, add = self.bn.scale_shift(y)
            y = q(y * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1))
        else:
            mul, add = self.bn.scale_shift(x)
            y = q(self.conv(x, self.conv.weight * mul.view(-1, 1, 1, 1), add))
        return q(F.silu(y)) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool, eps: float) -> None:
        super().__init__()
        self.cv1 = ConvBNAct(c, c, 3, eps)
        self.cv2 = ConvBNAct(c, c, 3, eps)
        self.add = shortcut

    def forward(self, x: Tensor) -> Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepVGGDW(nn.Module):
    """Depthwise 7x7 and 3x3 branches (each with BN), SiLU on their sum."""

    def __init__(self, c: int, eps: float) -> None:
        super().__init__()
        self.conv = ConvBNAct(c, c, 7, eps, groups=c, padding=3, act=False)
        self.conv1 = ConvBNAct(c, c, 3, eps, groups=c, padding=1, act=False)

    def forward(self, x: Tensor) -> Tensor:
        return F.silu(self.conv(x) + self.conv1(x))


class CIB(nn.Module):
    def __init__(self, c: int, shortcut: bool, lk: bool, eps: float) -> None:
        super().__init__()
        mid = 2 * c
        self.cv1 = nn.ModuleList([
            ConvBNAct(c, c, 3, eps, groups=c),
            ConvBNAct(c, mid, 1, eps),
            RepVGGDW(mid, eps) if lk else ConvBNAct(mid, mid, 3, eps, groups=mid),
            ConvBNAct(mid, c, 1, eps),
            ConvBNAct(c, c, 3, eps, groups=c),
        ])
        self.add = shortcut

    def forward(self, x: Tensor) -> Tensor:
        y = x
        for m in self.cv1:
            y = m(y)
        return x + y if self.add else y


class C2f(nn.Module):
    """C2f; with `lk` a bool, C2fCIB (CIB inner blocks with that long-kernel flag)."""

    def __init__(self, c_in: int, c_out: int, n: int, shortcut: bool, eps: float, lk: Optional[bool] = None) -> None:
        super().__init__()
        self.c = c_out // 2
        self.cv1 = ConvBNAct(c_in, 2 * self.c, 1, eps)
        self.cv2 = ConvBNAct((2 + n) * self.c, c_out, 1, eps)
        inner = (lambda: Bottleneck(self.c, shortcut, eps)) if lk is None else (lambda: CIB(self.c, shortcut, lk, eps))
        self.m = nn.ModuleList(inner() for _ in range(n))

    def forward(self, x: Tensor) -> Tensor:
        y = self.cv1(x)
        ys = [y[:, : self.c], y[:, self.c:]]
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class SCDown(nn.Module):
    def __init__(self, c_in: int, c_out: int, eps: float) -> None:
        super().__init__()
        self.cv1 = ConvBNAct(c_in, c_out, 1, eps)
        self.cv2 = ConvBNAct(c_out, c_out, 3, eps, stride=2, groups=c_out, act=False)

    def forward(self, x: Tensor) -> Tensor:
        return self.cv2(self.cv1(x))


class SPPF(nn.Module):
    def __init__(self, c_in: int, c_out: int, eps: float, k: int = 5) -> None:
        super().__init__()
        self.k = k
        self.cv1 = ConvBNAct(c_in, c_in // 2, 1, eps)
        self.cv2 = ConvBNAct(c_in // 2 * 4, c_out, 1, eps)

    def forward(self, x: Tensor) -> Tensor:
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


class Attention(nn.Module):
    """Multi-head self-attention over the map's positions, plus a depthwise
    3x3 positional branch on the values; per head the qkv channels are
    (key_dim q, key_dim k, head_dim v)."""

    def __init__(self, dim: int, num_heads: int, eps: float, attn_ratio: float = 0.5) -> None:
        super().__init__()
        self.nh = num_heads
        self.hd = dim // num_heads
        self.kd = int(self.hd * attn_ratio)
        self.scale = self.kd ** -0.5
        self.qkv = ConvBNAct(dim, dim + 2 * self.kd * num_heads, 1, eps, act=False)
        self.proj = ConvBNAct(dim, dim, 1, eps, act=False)
        self.pe = ConvBNAct(dim, dim, 3, eps, groups=dim, act=False)

    def forward(self, x: Tensor) -> Tensor:
        b, c, h, w = x.shape
        qkv = self.qkv(x).view(b, self.nh, 2 * self.kd + self.hd, h * w)
        q, k, v = qkv.split([self.kd, self.kd, self.hd], dim=2)
        attn = torch.softmax((q.transpose(-2, -1) @ k) * self.scale, dim=-1)  # [b, nh, n, n]
        out = (v @ attn.transpose(-2, -1)).reshape(b, c, h, w)
        return self.proj(out + self.pe(v.reshape(b, c, h, w)))


class PSA(nn.Module):
    def __init__(self, c_in: int, eps: float) -> None:
        super().__init__()
        self.c = c_in // 2
        self.cv1 = ConvBNAct(c_in, 2 * self.c, 1, eps)
        self.cv2 = ConvBNAct(2 * self.c, c_in, 1, eps)
        self.attn = Attention(self.c, max(1, self.c // 64), eps)
        self.ffn = nn.ModuleList([ConvBNAct(self.c, 2 * self.c, 1, eps), ConvBNAct(2 * self.c, self.c, 1, eps, act=False)])

    def forward(self, x: Tensor) -> Tensor:
        y = self.cv1(x)
        a, b = y[:, : self.c], y[:, self.c:]
        b = b + self.attn(b)
        b = b + self.ffn[1](self.ffn[0](b))
        return self.cv2(torch.cat((a, b), 1))


def _c2f(cfg: dict, node: str, c_in: int, c_out: int, n: int, shortcut: bool, lk: bool) -> C2f:
    eps = cfg["bn_eps"]
    if cfg["block_types"][node] == "C2fCIB":
        return C2f(c_in, c_out, n, True, eps, lk=lk)
    return C2f(c_in, c_out, n, shortcut, eps)


class Backbone(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        ch = {int(k): v for k, v in cfg["channels"].items()}
        reps = {int(k): v for k, v in cfg["repeats"].items()}
        eps = cfg["bn_eps"]
        self.cv0 = ConvBNAct(3, ch[0], 3, eps, stride=2)
        self.cv1 = ConvBNAct(ch[0], ch[1], 3, eps, stride=2)
        self.c2 = C2f(ch[1], ch[2], reps[2], True, eps)
        self.cv3 = ConvBNAct(ch[2], ch[3], 3, eps, stride=2)
        self.c4 = C2f(ch[3], ch[4], reps[4], True, eps)
        self.sc5 = SCDown(ch[4], ch[5], eps)
        self.c6 = _c2f(cfg, "c6", ch[5], ch[6], reps[6], True, False)
        self.sc7 = SCDown(ch[6], ch[7], eps)
        self.c8 = _c2f(cfg, "c8", ch[7], ch[8], reps[8], True, cfg["use_lk_c8"])
        self.sppf9 = SPPF(ch[8], ch[9], eps)
        self.psa10 = PSA(ch[9], eps)


class Neck(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        ch = {int(k): v for k, v in cfg["channels"].items()}
        hch = {int(k): v for k, v in cfg["neck_channels"].items()}
        reps = {int(k): v for k, v in cfg["repeats"].items()}
        eps = cfg["bn_eps"]
        c3, c4, c5 = ch[3], ch[5], ch[7]
        self.p5_p4_c2f = _c2f(cfg, "p5_p4", c5 + c4, hch[13], reps[13], False, cfg["use_lk_p5_p4"])
        self.p4_p3_c2f = C2f(hch[13] + c3, hch[16], reps[16], False, eps)
        self.p3_down = ConvBNAct(hch[16], hch[16], 3, eps, stride=2)
        self.p3_p4_c2f = _c2f(cfg, "p3_p4", hch[16] + hch[13], hch[19], reps[19], False, False)
        self.p4_down = SCDown(hch[19], hch[19], eps)
        self.p4_p5_c2f = C2f(hch[19] + c5, hch[22], reps[22], True, eps, lk=cfg["use_lk_p4_p5"])


def _branches(cfg: dict) -> Tuple[List[int], int, int]:
    hch = {int(k): v for k, v in cfg["neck_channels"].items()}
    ch = [hch[16], hch[19], hch[22]]
    reg_max, nc = cfg["reg_max"], cfg["nc"]
    return ch, max(16, ch[0] // 4, reg_max * 4), max(ch[0], min(nc, 100))


class Head(nn.Module):
    """v10Detect: per level a box branch (two 3x3 convs, a 1x1 to 4 x reg_max
    bins) and a class branch (dw3x3, 1x1, dw3x3, 1x1, a 1x1 to nc logits),
    for one2many (`cv2`, `cv3`) and one2one (`one2one_cv2`, `one2one_cv3`)."""

    def __init__(self, cfg: dict) -> None:
        super().__init__()
        ch, c2, c3 = _branches(cfg)
        reg_max, nc, eps = cfg["reg_max"], cfg["nc"], cfg["bn_eps"]

        def reg(c):
            return nn.Sequential(ConvBNAct(c, c2, 3, eps), ConvBNAct(c2, c2, 3, eps), Conv(c2, 4 * reg_max, 1, bias=True))

        def cls(c):
            return nn.Sequential(nn.Sequential(ConvBNAct(c, c, 3, eps, groups=c), ConvBNAct(c, c3, 1, eps)),
                                 nn.Sequential(ConvBNAct(c3, c3, 3, eps, groups=c3), ConvBNAct(c3, c3, 1, eps)),
                                 Conv(c3, nc, 1, bias=True))

        for prefix in ("", "one2one_"):
            setattr(self, prefix + "cv2", nn.ModuleList(reg(c) for c in ch))
            setattr(self, prefix + "cv3", nn.ModuleList(cls(c) for c in ch))


BRANCH_PREFIX = {"one2many": "", "one2one": "one2one_"}


class YOLOv10(nn.Module):
    def __init__(self, cfg: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.neck = Neck(cfg)
        self.head = Head(cfg)
        self.register_buffer("input_subtract", torch.zeros(3))
        self.register_buffer("input_divide", torch.full((3,), 255.0))
        self.checkpoint = False

    def set_quant(self, quant: Optional[str]) -> "YOLOv10":
        for m in self.modules():
            if isinstance(m, Conv):
                m.quant = quant
        return self

    def _node(self, fn, *args):
        if self.checkpoint and torch.is_grad_enabled():
            return _checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward(self, images: Tensor, branches: Sequence[str] = ("one2many", "one2one")) -> Dict[str, List]:
        """images NHWC raw pixels -> {branch: [(reg [B,H,W,4R], cls [B,H,W,nc]) per level]}."""
        x = (images.float() - self.input_subtract) / self.input_divide
        x = x.permute(0, 3, 1, 2).contiguous()
        n = self._node
        bb, nk = self.backbone, self.neck
        x = n(bb.c2, n(bb.cv1, n(bb.cv0, x)))
        c3 = n(bb.c4, n(bb.cv3, x))
        c4 = n(bb.c6, n(bb.sc5, c3))
        c5 = n(bb.psa10, n(bb.sppf9, n(bb.c8, n(bb.sc7, c4))))
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        p4 = n(nk.p5_p4_c2f, torch.cat([up(c5), c4], 1))
        p3 = n(nk.p4_p3_c2f, torch.cat([up(p4), c3], 1))
        p4 = n(nk.p3_p4_c2f, torch.cat([n(nk.p3_down, p3), p4], 1))
        p5 = n(nk.p4_p5_c2f, torch.cat([n(nk.p4_down, p4), c5], 1))
        out = {}
        for br in branches:
            pre = BRANCH_PREFIX[br]
            regs, clss = getattr(self.head, pre + "cv2"), getattr(self.head, pre + "cv3")
            out[br] = [(n(r, f).permute(0, 2, 3, 1), n(c, f).permute(0, 2, 3, 1)) for r, c, f in zip(regs, clss, (p3, p4, p5))]
        return out

    @torch.no_grad()
    def calibrate(self, images: Tensor) -> None:
        """Every BN's running statistics := its batch statistics on `images`
        (biased variance), computed in the forward's order."""
        bns = [m for m in self.modules() if isinstance(m, BatchNorm)]
        for m in bns:
            m.calibrating = True
        try:
            self.forward(images)
        finally:
            for m in bns:
                m.calibrating = False


def num_params(cfg: dict, *, deploy: bool = True) -> int:
    """Parameters of the model (deploy: the one2one head only, the BN folded
    into its conv, RepVGGDW's branches merged: the count the published table
    gives)."""
    m = YOLOv10(cfg)
    total = 0
    for name, p in m.named_parameters():
        if deploy and (name.startswith("head.cv2") or name.startswith("head.cv3")):
            continue
        if deploy and (".bn." in name and name.endswith("weight")):
            continue  # folded: the BN's bias becomes the conv's bias
        if deploy and ".conv1." in name:
            continue  # RepVGGDW's 3x3 branch merged into the 7x7
        total += p.numel()
    return total


def dfl_boxes(reg: Tensor, hw: Sequence[Tuple[int, int]], strides: Sequence[int], reg_max: int) -> Tensor:
    """reg logits [B, A, 4 R] (levels concatenated) -> xyxy pixel boxes [B, A, 4]:
    softmax over each side's bins, the expected bin, anchor centre (cell
    centre + 0.5) minus left/top and plus right/bottom, times the stride."""
    pts, st = [], []
    for (h, w), s in zip(hw, strides):
        gy, gx = torch.meshgrid(torch.arange(h, device=reg.device, dtype=torch.float32) + 0.5,
                                torch.arange(w, device=reg.device, dtype=torch.float32) + 0.5, indexing="ij")
        pts.append(torch.stack((gx, gy), -1).reshape(-1, 2))
        st.append(torch.full((h * w, 1), float(s), device=reg.device))
    pts, st = torch.cat(pts), torch.cat(st)
    p = torch.softmax(reg.float().reshape(*reg.shape[:-1], 4, reg_max), -1)
    d = p @ torch.arange(reg_max, device=reg.device, dtype=torch.float32)
    return torch.cat((pts - d[..., :2], pts + d[..., 2:]), -1) * st


def flat_maps(levels: Sequence[Tuple[Tensor, Tensor]]) -> Tuple[Tensor, Tensor, List[Tuple[int, int]]]:
    """Per-level (reg, cls) NHWC -> (reg [B, A, 4R], cls [B, A, nc], [(h, w)])."""
    b = levels[0][0].shape[0]
    hw = [(r.shape[1], r.shape[2]) for r, _ in levels]
    reg = torch.cat([r.reshape(b, -1, r.shape[-1]) for r, _ in levels], 1)
    cls = torch.cat([c.reshape(b, -1, c.shape[-1]) for _, c in levels], 1)
    return reg, cls, hw


def init_scale(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(mean, std) of the seeded draw of a leaf, by its role: conv weights
    N(0, 1/fan_in) (the BN that follows sets the scale), BN gamma 1 + N(0,
    0.1^2), BN beta N(0, 0.1^2), the head's box bias N(0, 0.1^2) and class
    bias -3.5 + N(0, 0.1^2)."""
    if name.endswith("running_mean") or name.endswith("running_var"):
        raise ValueError("running statistics are calibrated, not drawn")
    if len(shape) == 4:
        fan_in = shape[1] * shape[2] * shape[3]
        return 0.0, 1.0 / math.sqrt(fan_in)
    if ".bn.weight" in name:
        return 1.0, 0.1
    if name.startswith("head.") and name.count(".") == 4 and "cv3." in name:
        return -3.5, 0.1  # head.{,one2one_}cv3.<level>.2.bias: the class logits' bias
    return 0.0, 0.1
