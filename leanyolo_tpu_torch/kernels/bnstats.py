"""The training BatchNorm's one-pass batch moments (K8), forward and
backward: CUDA kernels (csrc/bnstats.cu) and plain versions.

Replaces the hand-shaped lax program of the JAX package's
`leanyolo_tpu/models/yolov10/layers.py:189 _bn_act`, train branch
(`:200-205`): s1 = sum y and s2 = sum y^2 in fp32 over (N, H, W) in one read
of the conv output. `models/yolov10/layers.py::_BatchMoments` calls both
wrappers in every training-mode BatchNorm; the mean, the clamped variance
and the all-reduce over a data-parallel group stay there.

`bn_moments(y)`: y [N, C, H, W] bf16 or fp32 -> (s1, s2), fp32 [C] each. The
order of the additions is fixed by the shape alone, so a tensor gives the
same bits on every launch, in either memory layout, and in the plain
version. The N*H*W rows (row r is pixel (n, h, w), in that order) are dealt
to G = `slots(rows, C)` slots of 32 lanes: row r goes to lane r % 32 of
slot (r // 32) % G as its step r // (32 G). Each lane adds its rows in step
order from +0.0 (s2 adds y*y rounded, then the sum rounded: no fused
multiply-add); a slot's 32 lane sums meet in a pairwise tree, a[l] += a[l +
h] for l a multiple of 2h, h = 1, 2, 4, 8, 16, and the G slot sums meet in
the same pairwise tree. Rows past the end add nothing, as +0.0 would (a sum
started at +0.0 is never -0.0). On the card a CTA is a slot, and the last
CTA of a channel tile to finish (an integer ticket, kept by the binding for
each device and stream; no floating-point atomics) combines the slot sums.

`bn_moments_bwd(y, g_s1, g_s2)`: dy = g_s1[c] + (2 y) g_s2[c] in fp32,
rounded after the product and after the sum, then cast once to y's dtype
(the chain rule of s1 and s2; `_BatchMoments.backward` forms g_s1 and g_s2
from the gradients of the mean and the variance).

Routes, chosen by `route`: "vec" (16-byte loads: y in channels_last memory
with C a multiple of 8 bf16 or 4 fp32 values, 16-byte aligned; every BN of
the training path) and "general" (any strides and C, one value a thread).
`LAUNCHES["bn_moments"]` and `["bn_moments_bwd"]` count both routes,
`["bn_moments_vec"]` and `["bn_moments_bwd_vec"]` the 16-byte route. CPU
tensors take the plain versions; CUDA tensors launch a kernel or raise.

Bound on an H100: bytes. Forward: y read once (2.55 GB a batch-32 yolov10s
640 bf16 step over its 99 BNs: 0.76 ms at 3.35 TB/s); backward: y read and
dy written (1.52 ms).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import LAUNCHES
from ._build import check_cuda, ext

LANES = 32  # row lanes of a slot (csrc/bnstats.cu kLanes)
PARTIALS = 16384  # slots x C, the target of `slots`: 65,536 threads a bf16 launch
MAX_SLOTS = 256  # the kernel's last CTA reads at most 8 slots a lane, in two rounds
ONE_ROUND = 128  # ... and 4 in one round: the most slots of a map of at most BIG_ROWS rows
BIG_ROWS = 1 << 18


def slots(rows: int, c: int) -> int:
    """G, the slots the rows are dealt to: the largest power of two with G C
    <= PARTIALS, 32 G <= rows and G <= ONE_ROUND (MAX_SLOTS where rows >
    BIG_ROWS), at least 1. By the shape alone: never by the card's SM
    count."""
    most = min(PARTIALS // max(c, 1), rows // LANES, MAX_SLOTS if rows > BIG_ROWS else ONE_ROUND)
    g = 1
    while 2 * g <= most:
        g *= 2
    return g


def rows_per_lane(rows: int, c: int) -> int:
    """The steps of a lane: the rows each lane adds (the last step of some
    lanes past the end)."""
    return -(-rows // (LANES * slots(rows, c)))


def _tree(a: torch.Tensor) -> torch.Tensor:
    """[..., n, C] -> [..., C], n a power of two: the pairwise tree, a[l] +=
    a[l + h] for l a multiple of 2h, h = 1, 2, 4, ..., n / 2."""
    while a.shape[-2] > 1:
        a = a[..., 0::2, :] + a[..., 1::2, :]
    return a[..., 0, :]


def _lane_sums(steps) -> Tuple[torch.Tensor, torch.Tensor]:
    """steps: [G, LANES, C] fp32 tensors in step order -> the lanes' serial
    sums of them and of their squares, each [G, LANES, C]."""
    a1 = a2 = None
    for xk in steps:
        if a1 is None:
            a1, a2 = torch.zeros_like(xk), torch.zeros_like(xk)
        a1 += xk
        a2 += xk * xk
    return a1, a2


def _padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x [r, C] with zero rows appended up to `rows`."""
    return torch.cat([x, x.new_zeros(rows - x.shape[0], x.shape[1])]) if rows > x.shape[0] else x


def _steps(x: torch.Tensor, g: int):
    """x [rows, C] -> its steps, [g, LANES, C] each (the last padded with
    zero rows)."""
    step = g * LANES
    full = x.shape[0] // step
    for k in range(full):
        yield x[k * step:(k + 1) * step].view(g, LANES, x.shape[1])
    if x.shape[0] > full * step:
        yield _padded(x[full * step:], step).view(g, LANES, x.shape[1])


def bn_moments_plain(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bn_moments`: the kernel's order in torch operations."""
    n, c, h, w = y.shape
    rows = n * h * w
    if rows == 0 or c == 0:
        return y.new_zeros(c, dtype=torch.float32), y.new_zeros(c, dtype=torch.float32)
    x = y.permute(0, 2, 3, 1).reshape(rows, c).float()  # row r = pixel (n, h, w); a view in channels_last
    g = slots(rows, c)
    return tuple(_tree(_tree(part)) for part in _lane_sums(_steps(x, g)))  # lanes, then slots


def bn_moments_bwd_plain(y: torch.Tensor, g_s1: torch.Tensor, g_s2: torch.Tensor) -> torch.Tensor:
    """Plain version of `bn_moments_bwd`."""
    return (g_s1.view(1, -1, 1, 1) + 2.0 * y.float() * g_s2.view(1, -1, 1, 1)).to(y.dtype)


def route(y: torch.Tensor) -> str:
    """"vec" where y is channels_last and dense, C holds whole 16-byte
    vectors and y is 16-byte aligned, else "general"."""
    dense = y.is_contiguous(memory_format=torch.channels_last)
    return "vec" if dense and y.shape[1] % (16 // y.element_size()) == 0 and y.data_ptr() % 16 == 0 else "general"


def _check(y: torch.Tensor, name: str) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {y.device}")
    if y.dtype not in (torch.bfloat16, torch.float32) or y.ndim != 4:
        raise ValueError(f"{name}: bf16 or fp32 [N, C, H, W], got {y.dtype} {tuple(y.shape)}")


def bn_moments(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """y [N, C, H, W] bf16 or fp32 -> (sum y, sum y^2) over N, H, W, fp32 [C]
    each, in the fixed order of the module doc."""
    if y.device.type == "cpu":
        return bn_moments_plain(y)
    _check(y, "bn_moments")
    n, c, h, w = y.shape
    rows = n * h * w
    if rows == 0 or c == 0:
        return y.new_zeros(c, dtype=torch.float32), y.new_zeros(c, dtype=torch.float32)
    g = slots(rows, c)
    buf = torch.empty((2 * g + 2) * c, dtype=torch.float32, device=y.device)  # the partials, then s1, s2
    partials, s1, s2 = buf[: 2 * g * c], buf[2 * g * c: (2 * g + 1) * c], buf[(2 * g + 1) * c:]
    vec = route(y) == "vec"
    ext().bn_moments(y, partials, s1, s2, g, vec)
    LAUNCHES["bn_moments_vec"] += vec
    LAUNCHES["bn_moments"] += 1
    return s1, s2


def bn_moments_bwd(y: torch.Tensor, g_s1: torch.Tensor, g_s2: torch.Tensor) -> torch.Tensor:
    """y [N, C, H, W] bf16 or fp32, g_s1 and g_s2 fp32 [C] -> dy in y's dtype
    and memory layout: g_s1[c] + (2 y) g_s2[c], rounded as the module doc says."""
    if y.device.type == "cpu":
        return bn_moments_bwd_plain(y, g_s1, g_s2)
    _check(y, "bn_moments_bwd")
    g_s1, g_s2 = g_s1.contiguous(), g_s2.contiguous()
    for g, name in ((g_s1, "g_s1"), (g_s2, "g_s2")):
        check_cuda(g, f"bn_moments_bwd {name}")
        if g.dtype != torch.float32 or g.numel() != y.shape[1]:
            raise ValueError(f"bn_moments_bwd: {name} must be fp32 [C], got {g.dtype} {tuple(g.shape)}")
    dy = torch.empty_like(y)
    if y.numel():
        vec = route(y) == "vec" and dy.stride() == y.stride() and dy.data_ptr() % 16 == 0
        ext().bn_moments_bwd(y, g_s1, g_s2, dy, vec)
        LAUNCHES["bn_moments_bwd_vec"] += vec
        LAUNCHES["bn_moments_bwd"] += 1
    return dy
