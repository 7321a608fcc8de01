"""Dense 3x3 stride-1 conv, 32 -> 32 channels, + bias + SiLU over the
space-to-depth form: CUDA kernel (csrc/s2dconv.cu) and plain version.

A 3x3 SAME conv on [B, H, W, C] equals a 2x2 VALID conv on
s2d(pad(x, 1)) [B, H/2+1, W/2+1, 4C] with the weights remapped by
`w_s2d_k3`, un-S2D'd. yolov10s runs it at C = 32 on the stage-1 bottleneck
(backbone c2.m[0].cv1, .cv2), where the S2D form is 128 channels wide.
Replaces the JAX package's Pallas kernels
`experiments/exp_pallas_k2.py:40 pallas_k2` and the bodies of
`experiments/exp_pallas_k2b.py:44 build` (the same function; k_v1 with all
four taps at offset (0, 0), which `taps` expresses). `s2d`, `un_s2d` and
`w_s2d_k3` are this package's copies of `experiments/exp_s2d.py:65-100`.

Rounding follows the folded JAX forward: the fp32 sum is rounded to the
activation dtype, the bias is added and rounded, the SiLU is applied and
rounded.

Two hand-written kernels, chosen by dtype: bf16 (every call of the serving
path) runs on a persistent wgmma kernel with the weights resident in shared
memory, read K-major as `pack_weights` holds them; fp32 on the CUDA cores.
A failed launch raises; no route stands in for the other. The wrapper is
the operator `leanyolo_tpu_torch::conv3x3_c32_bias_silu` (_build.operator).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import LAUNCHES
from ._build import check_cuda, ext, operator

C = 32
TAPS: Tuple[Tuple[int, int], ...] = ((0, 0), (0, 1), (1, 0), (1, 1))


def s2d(x: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H+2p)/2, (W+2p)/2, 4C]; phase-major channel order
    (qi, qj, ci), so channel c = (qi*2 + qj)*C + ci."""
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def un_s2d(y: torch.Tensor) -> torch.Tensor:
    b, hh, ww, c4 = y.shape
    c = c4 // 4
    y = y.reshape(b, hh, ww, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * hh, 2 * ww, c)


def w_s2d_k3(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, Ci, Co] -> [2, 2, 4Ci, 4Co] for the 2x2 VALID conv on
    s2d(pad(x, 1)).

    Y[I, J, (pi, pj, co)] = y[2I+pi, 2J+pj, co]; the 3x3 tap (di, dj) of
    output phase p reads padded-input row u = pi+di in S2D cell u//2,
    phase u%2. The 7 of 16 blocks no tap reaches stay zero.
    """
    ci, co = w.shape[2], w.shape[3]
    out = torch.zeros((2, 2, 4 * ci, 4 * co), dtype=w.dtype, device=w.device)
    for pi in range(2):
        for pj in range(2):
            for di in range(3):
                for dj in range(3):
                    ui, uj = pi + di, pj + dj
                    q = (ui % 2) * 2 + uj % 2
                    p = pi * 2 + pj
                    out[ui // 2, uj // 2, q * ci:(q + 1) * ci, p * co:(p + 1) * co] = w[di, dj]
    return out


def pack_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """A [32, 32, 3, 3] OIHW conv weight -> the kernel's [4, 128, 128]
    tap-major S2D weights, held K-major: a view of a contiguous [128 N,
    512 K] tensor (`k_major` takes it as it is), the layout the wgmma route
    reads."""
    w = w_s2d_k3(w_oihw.permute(2, 3, 1, 0)).reshape(4 * 4 * C, 4 * C)
    return w.t().contiguous().t().reshape(4, 4 * C, 4 * C)


def k_major(w_s2d: torch.Tensor) -> torch.Tensor:
    """[4, 128, 128] S2D weights -> the [128 N, 512 K] K-major matrix the
    wgmma route reads (no copy for weights that `pack_weights` made)."""
    if w_s2d.stride() == (128, 1, 512):
        return w_s2d.permute(2, 0, 1).reshape(4 * C, 16 * C)
    return w_s2d.reshape(16 * C, 4 * C).t().contiguous()


def s2d_conv_plain(xs: torch.Tensor, w_taps: torch.Tensor, bias: torch.Tensor,
                   taps: Sequence[Tuple[int, int]] = TAPS) -> torch.Tensor:
    """The TPU kernel's function on the S2D form, at the port's rounding points.

    xs [B, Hs+1, Ws+1, 4C], w_taps [4, 4C, N] (tap t at offset taps[t]),
    bias [N] -> [B, Hs, Ws, N] in xs's dtype: each tap slice as a 1x1 conv
    (a matrix product on the NHWC slice), summed in fp32.
    """
    ho, wo = xs.shape[1] - 1, xs.shape[2] - 1
    acc = None
    for t, (di, dj) in enumerate(taps):
        y = torch.matmul(xs[:, di:di + ho, dj:dj + wo].float(), w_taps[t].float())
        acc = y if acc is None else acc + y
    y = acc.to(xs.dtype) + bias.to(xs.dtype)
    return F.silu(y)


def _taps_bits(taps: Sequence[Tuple[int, int]]) -> int:
    if len(taps) != 4 or any(d not in (0, 1) for tap in taps for d in tap):
        raise ValueError(f"s2dconv: four tap offsets in {{0, 1}}^2, got {taps}")
    return sum((di << (2 * t)) | (dj << (2 * t + 1)) for t, (di, dj) in enumerate(taps))


def conv3x3_c32_bias_silu_plain(x: torch.Tensor, w_s2d: torch.Tensor, bias: torch.Tensor,
                                taps: Sequence[Tuple[int, int]] = TAPS) -> torch.Tensor:
    """x [B, H, W, 32] NHWC, w_s2d [4, 128, 128], bias [32] -> [B, H, W, 32]
    in x's dtype. An odd H or W gets one more zero row or column, cut off
    again after the conv."""
    _, h, w, _ = x.shape
    xs = s2d(F.pad(x, (0, 0, 1, 1 + w % 2, 1, 1 + h % 2)))
    y = un_s2d(s2d_conv_plain(xs, w_s2d, bias.repeat(4), taps))
    return y[:, :h, :w]


def _pixel_strides_ok(x: torch.Tensor, elt: int) -> bool:
    """Channels contiguous, the pixels of each image evenly strided, 16-byte aligned."""
    vec = 16 // elt
    return (x.stride(3) == 1 and x.stride(1) == x.shape[2] * x.stride(2) and x.stride(2) % vec == 0
            and x.stride(0) % vec == 0 and x.data_ptr() % 16 == 0)


def _taps_of(bits: int) -> Tuple[Tuple[int, int], ...]:
    return tuple(((bits >> (2 * t)) & 1, (bits >> (2 * t + 1)) & 1) for t in range(4))


def _s2dconv_cpu(x: torch.Tensor, w_s2d: torch.Tensor, bias: torch.Tensor, taps: int) -> torch.Tensor:
    return conv3x3_c32_bias_silu_plain(x, w_s2d, bias, _taps_of(taps)).contiguous()


def _s2dconv_fake(x: torch.Tensor, w_s2d: torch.Tensor, bias: torch.Tensor, taps: int) -> torch.Tensor:
    return x.new_empty(x.shape)


def _s2dconv_cuda(x: torch.Tensor, w_s2d: torch.Tensor, bias: torch.Tensor, taps: int) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 4 or x.shape[-1] != C:
        raise ValueError(f"s2dconv: bf16 or fp32 x [B, H, W, {C}], got {x.dtype} {tuple(x.shape)}")
    if tuple(w_s2d.shape) != (4, 4 * C, 4 * C) or tuple(bias.shape) != (C,):
        raise ValueError(f"s2dconv: need w_s2d [4, 128, 128] and bias [{C}], got {tuple(w_s2d.shape)}, "
                         f"{tuple(bias.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"s2dconv: expected a CUDA tensor, got one on {x.device}")
    if not _pixel_strides_ok(x, x.element_size()):
        x = x.clone(memory_format=torch.contiguous_format)
    bk = bias.to(x.dtype).contiguous()
    check_cuda(bk, "s2dconv b")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        wk = k_major(w_s2d.to(x.dtype))
        check_cuda(wk, "s2dconv w")
        if out.numel():
            ext().s2dconv_wgmma(x, wk, bk, out, taps)
            LAUNCHES["s2dconv_wgmma"] += 1
            LAUNCHES["s2dconv"] += 1
        return out
    wk = w_s2d.to(x.dtype).contiguous()
    check_cuda(wk, "s2dconv w")
    if out.numel():
        ext().s2dconv(x, wk, bk, out, taps)
        LAUNCHES["s2dconv"] += 1
    return out


_S2DCONV = operator("conv3x3_c32_bias_silu", "(Tensor x, Tensor w_s2d, Tensor bias, int taps) -> Tensor",
                    cpu=_s2dconv_cpu, cuda=_s2dconv_cuda, fake=_s2dconv_fake)


def conv3x3_c32_bias_silu(x: torch.Tensor, w_s2d: torch.Tensor, bias: torch.Tensor,
                          taps: Sequence[Tuple[int, int]] = TAPS) -> torch.Tensor:
    """x [B, H, W, 32] NHWC (a channel slice of a wider map is read in
    place on the card), w_s2d [4, 128, 128] (pack_weights), bias [32] ->
    [B, H, W, 32] contiguous, in x's dtype, through the operator
    `leanyolo_tpu_torch::conv3x3_c32_bias_silu` (taps as 8 bits). bf16
    takes the wgmma kernel, fp32 the CUDA-core one."""
    return _S2DCONV(x, w_s2d, bias, _taps_bits(taps))
