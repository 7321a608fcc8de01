"""Fused stem: CUDA kernels (csrc/stem.cu) and plain version.

Computes backbone cv0 + cv1 of the folded model, the two 3x3 stride-2
conv + bias + SiLU, on raw NHWC images, with the input normalization
already folded into conv0's weights. Replaces the JAX package's Pallas
kernels `experiments/stem_pallas.py:254 fused_stem` and
`:204 fused_stem_v2` (the same function in two layouts).

Rounding follows the folded JAX forward: each conv's fp32 sum is rounded to
the activation dtype, the bias is added and rounded, the SiLU is applied and
rounded. The kernels keep the conv0 activations in shared memory, so they
never go to device memory.

Two hand-written kernels, chosen by the activation dtype: bf16 (every call
of the serving path) runs both convs on the tensor cores (mma.sync) with
the weights packed once by `pack_weights` (csrc/stem_tc.cu); fp32 runs on
the CUDA cores with fp32 FMAs (csrc/stem.cu). Both take the stem widths of
all six YOLOv10 sizes (`WIDTHS`). A failed launch raises; no route stands
in for the other. The wrapper is the operator `leanyolo_tpu_torch::fused_stem`
(_build.operator): CPU -> the plain version, CUDA -> the kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.yolov10.config import VARIANTS
from . import LAUNCHES
from ._build import check_cuda, ext, operator

# (conv0, conv1) output widths the kernels take: backbone cv0/cv1 of every
# YOLOv10 size (the kernels are compiled for these, csrc/kernels.h
# STEM_WIDTHS).
WIDTHS = tuple(sorted({(cfg.ch[0], cfg.ch[1]) for cfg in VARIANTS.values()}))

# Where conv0's k16 step of kernel row kh reads: k = 0..7 is the pixel pair
# (2c, 2c+1), k = 8..15 the pair (2c+2, 2c+3), 3 channels a pixel and 2
# zeros a pair. (kw, ci) of each k, or None where the weight is zero.
CONV0_K = tuple([(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2), None, None,
                 (2, 0), (2, 1), (2, 2), None, None, None, None, None])


def _fragment_index(n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, column) of each element of the mma.sync m16n8k16 B fragments of a
    [16, n] matrix, as [n/16, 32 lanes, 8]: lane l holds, for each of two n8
    tiles h, B[k, 16 jp + 8 h + l // 4] at k = 2 (l % 4) + (0, 1, 8, 9)."""
    lane = torch.arange(32)
    k = 2 * (lane % 4)[:, None] + torch.tensor([0, 1, 8, 9])                        # [32, 4]
    col = (16 * torch.arange(n // 16)[:, None, None] + 8 * torch.arange(2)[None, None, :]
           + (lane // 4)[None, :, None])                                            # [n/16, 32, 2]
    k = k[None, :, None, :].expand(n // 16, 32, 2, 4)
    col = col[..., None].expand(n // 16, 32, 2, 4)
    return k.reshape(n // 16, 32, 8), col.reshape(n // 16, 32, 8)


def to_fragments(b: torch.Tensor) -> torch.Tensor:
    """[S, 16, N] B matrices (one per k16 step) -> [S, N/16, 32, 8], the
    order a warp's lanes read them in (16 bytes a lane for two n8 tiles)."""
    k, col = _fragment_index(b.shape[2])
    return b[:, k, col].contiguous()


def conv0_matrix(w0: torch.Tensor) -> torch.Tensor:
    """conv0 weights [c0, 3, 3, 3] OIHW -> its GEMM's B, [3 kernel rows, 16, c0]
    (K = 16 a row, laid out as CONV0_K; zero rows where no tap lands)."""
    b = w0.new_zeros(3, 16, w0.shape[0])
    for k, kc in enumerate(CONV0_K):
        if kc is not None:
            b[:, k] = w0[:, kc[1], :, kc[0]].t()
    return b


def conv1_matrix(w1: torch.Tensor) -> torch.Tensor:
    """conv1 weights [c1, c0, 3, 3] OIHW -> its GEMM's B, [9 c0/16, 16, c1]:
    k16 step (kh * 3 + kw) * c0/16 + cb holds input channels cb*16 .. +15."""
    c1, c0 = w1.shape[:2]
    return w1.permute(2, 3, 1, 0).reshape(9 * c0 // 16, 16, c1)


def pack_weights(w0: torch.Tensor, w1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv0 [c0, 3, 3, 3] and conv1 [c1, c0, 3, 3] OIHW weights -> the
    tensor-core kernel's B fragments, [3, c0/16 * 256] and
    [9 c0/16, c1/16 * 256] (`to_fragments` flattened after the k16 step, so
    that no 4-D memory-format conversion of a module touches them), in the
    weights' dtype and device."""
    return to_fragments(conv0_matrix(w0)).flatten(1), to_fragments(conv1_matrix(w1)).flatten(1)


def _conv_bias_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x, w.to(x.dtype), None, 2, 1)
    return F.silu(y + b.to(y.dtype).view(1, -1, 1, 1))


def fused_stem_plain(images, w0, b0, w1, b1, *, dtype: torch.dtype) -> torch.Tensor:
    """images [B, H, W, 3] (uint8 or float) -> [B, H/4, W/4, c1] NHWC in `dtype`."""
    x = images.to(dtype).permute(0, 3, 1, 2)
    return _conv_bias_silu(_conv_bias_silu(x, w0, b0), w1, b1).permute(0, 2, 3, 1)


def _stem_cpu(images, w0, b0, w1, b1, dtype, w0p, w1p):
    return fused_stem_plain(images, w0, b0, w1, b1, dtype=dtype).contiguous()


def _stem_fake(images, w0, b0, w1, b1, dtype, w0p, w1p):
    b, h, w, _ = images.shape
    h1, w1_ = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # two 3x3 stride-2 pad-1 convs
    return images.new_empty((b, (h1 - 1) // 2 + 1, (w1_ - 1) // 2 + 1, w1.shape[0]), dtype=dtype)


def _stem_cuda(images, w0, b0, w1, b1, dtype, w0p, w1p):
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
    if images.data_ptr() % 16:
        images = images.clone()
    b0k, b1k = b0.to(dtype).contiguous(), b1.to(dtype).contiguous()
    out = torch.empty(b, h // 4, w // 4, c1, dtype=dtype, device=images.device)
    if dtype == torch.bfloat16:
        if w0p is None or w1p is None:
            raise ValueError("fused_stem: the bf16 route takes the weights packed once, "
                             "packed=pack_weights(w0, w1)")
        w0p, w1p = w0p.to(dtype).contiguous(), w1p.to(dtype).contiguous()
        for t, name in ((w0p, "w0 packed"), (w1p, "w1 packed"), (b0k, "b0"), (b1k, "b1")):
            check_cuda(t, f"fused_stem {name}")
        if b:
            ext().stem_tc(images, w0p, b0k, w1p, b1k, out)
            LAUNCHES["stem_tc"] += 1
            LAUNCHES["stem"] += 1
        return out
    # fp32: HWIO weights, the kernel reads one tap's output channels contiguously.
    w0k = w0.to(dtype).permute(2, 3, 1, 0).contiguous()
    w1k = w1.to(dtype).permute(2, 3, 1, 0).contiguous()
    for t, name in ((w0k, "w0"), (w1k, "w1"), (b0k, "b0"), (b1k, "b1")):
        check_cuda(t, f"fused_stem {name}")
    if b:
        ext().stem(images, w0k, b0k, w1k, b1k, out)
        LAUNCHES["stem"] += 1
    return out


_FUSED_STEM = operator(
    "fused_stem", "(Tensor images, Tensor w0, Tensor b0, Tensor w1, Tensor b1, ScalarType dtype, Tensor? w0p, "
    "Tensor? w1p) -> Tensor", cpu=_stem_cpu, cuda=_stem_cuda, fake=_stem_fake)


def fused_stem(images, w0, b0, w1, b1, *, dtype: Optional[torch.dtype] = None,
               packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Folded cv0+cv1: images [B, H, W, 3] NHWC, w0 [c0, 3, 3, 3], b0 [c0],
    w1 [c1, c0, 3, 3], b1 [c1] -> [B, H/4, W/4, c1] NHWC in `dtype`
    (default: w0's dtype), through the operator `leanyolo_tpu_torch::fused_stem`.
    `packed`: `pack_weights(w0, w1)`, packed once by the caller; the bf16
    route on the card reads only these and raises without them. On the
    card H and W must be multiples of 32."""
    w0p, w1p = (None, None) if packed is None else packed
    return _FUSED_STEM(images, w0, b0, w1, b1, w0.dtype if dtype is None else dtype, w0p, w1p)
