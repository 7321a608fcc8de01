"""Backward of the k x k stride-1 "same" max pool: CUDA kernel (csrc/mpbwd.cu)
and plain version.

The SPPF pools' backward in the train step
(`leanyolo_tpu/models/yolov10/layers.py:251-262`, `:335-341`). Replaces the
JAX package's Pallas kernel `experiments/exp_sppf_bwd.py:83 mpbwd_pallas`,
for any B, H, W, C and odd k. Routing: the dy of each window goes to the
first position of the window, in row-major order, that holds the window
max; each dx sums its routed dy in f32, in ascending window offset, and
rounds once. The kernels and the plain version reproduce the Pallas kernel
bit for bit.

Two hand-written kernels, chosen by shape (`route`): the 16-byte route
(a whole map per CTA, 8 bf16 or 4 fp32 channels a thread; every pool of the
train step) where C is a multiple of 8 bf16 or 4 fp32 values and the
tensors are 16-byte aligned, the general route (a lane a channel) for the
rest. A failed launch raises; no route stands in for the other.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from ._build import check_cuda, ext


def mpbwd_plain(x: torch.Tensor, dy: torch.Tensor, k: int = 5) -> torch.Tensor:
    """x, dy [B, H, W, C] NHWC -> dx [B, H, W, C] in x's dtype.

    The Pallas body's arithmetic: x padded with -inf, the window max, then
    one masked shifted f32 add per window offset d in row-major order, each
    window taking the first d that holds its max.
    """
    pad = k // 2
    b, h, w, c = x.shape
    xp = torch.full((b, h + 2 * pad, w + 2 * pad, c), float("-inf"), dtype=torch.float32, device=x.device)
    xp[:, pad : pad + h, pad : pad + w] = x.float()
    wmax = torch.full((b, h, w, c), float("-inf"), dtype=torch.float32, device=x.device)
    for dh in range(k):
        for dw in range(k):
            wmax = torch.maximum(wmax, xp[:, dh : dh + h, dw : dw + w])
    dyf = dy.float()
    taken = torch.zeros((b, h, w, c), dtype=torch.bool, device=x.device)
    dxp = torch.zeros_like(xp)
    for dh in range(k):
        for dw in range(k):
            m = (xp[:, dh : dh + h, dw : dw + w] == wmax) & ~taken
            taken |= m
            dxp[:, dh : dh + h, dw : dw + w] += torch.where(m, dyf, 0.0)
    return dxp[:, pad : pad + h, pad : pad + w].to(x.dtype)


def route(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> str:
    """"vec" (16-byte loads and stores) where C holds whole 16-byte vectors
    and every tensor is 16-byte aligned, else "general"."""
    per_vec = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
    return "vec" if x.shape[-1] % per_vec == 0 and aligned else "general"


def mpbwd(x: torch.Tensor, dy: torch.Tensor, k: int = 5) -> torch.Tensor:
    """x, dy [B, H, W, C] NHWC (contiguous on the card), bf16 or fp32 -> dx."""
    if x.device.type == "cpu":
        return mpbwd_plain(x, dy, k)
    check_cuda(x, "mpbwd x")
    check_cuda(dy, "mpbwd dy")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 4:
        raise ValueError(f"mpbwd: bf16 or fp32 NHWC input, got {x.dtype} {tuple(x.shape)}")
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"mpbwd: dy {dy.dtype} {tuple(dy.shape)} must match x {x.dtype} {tuple(x.shape)}")
    if k % 2 != 1 or not 1 <= k <= 15:
        raise ValueError(f"mpbwd: k must be odd in [1, 15], got {k}")
    dx = torch.empty_like(x)
    if x.numel():
        vec = route(x, dy, dx) == "vec"
        ext().mpbwd(x, dy, dx, k, vec)
        LAUNCHES["mpbwd_vec"] += vec
        LAUNCHES["mpbwd"] += 1
    return dx
