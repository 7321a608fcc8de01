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
version. The N*H*W rows (row r is pixel (n, h, w), in that order) are cut
into blocks of 32 R rows, R = `rows_per_lane(rows, C)`. In a block, lane l
(of 32) adds rows l, l + 32, ..., l + 32 (R - 1) one after another from
+0.0 (s2 adds y*y rounded, then the sum rounded: no fused multiply-add);
then the 32 lane sums meet in a tree, a[l] += a[l + h] for h = 16, 8, 4,
2, 1. That gives each block's partial sums [blocks, C]. Then lane l adds
partials l, l + 32, ... one after another, and the same tree gives the
result. Rows past the end add nothing, as +0.0 would (a sum started at +0.0
is never -0.0). The kernel's blocks run as CTAs; for each tile of channels
the last CTA to finish (an integer ticket, kept by the binding for each
device and stream; no floating-point atomics) sums the tile's partials.

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

LANES = 32  # row lanes of a block (csrc/bnstats.cu kLanes)
MIN_ROWS_PER_LANE = 8  # a lane's loads go out 8 rows at a time
MAX_ROWS_PER_LANE = 256
PARTIALS = 16384  # the most partial sums of a moment (blocks x C) where R allows


def rows_per_lane(rows: int, c: int) -> int:
    """R, the rows each lane of a block adds: the least power of two from 8
    to 256 for which the blocks (32 R rows each) number at most
    PARTIALS / C. By the shape alone: never by the card's SM count."""
    most = max(1, PARTIALS // max(c, 1))
    r = MIN_ROWS_PER_LANE
    while r < MAX_ROWS_PER_LANE and -(-rows // (LANES * r)) > most:
        r *= 2
    return r


def _tree(a: torch.Tensor) -> torch.Tensor:
    """[..., LANES, C] -> [..., C]: a[l] += a[l + h] for h = 16, 8, 4, 2, 1."""
    h = LANES // 2
    while h:
        a = a[..., :h, :] + a[..., h:2 * h, :]
        h //= 2
    return a[..., 0, :]


def _lane_sums(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb [blocks, K, LANES, C] fp32 -> the blocks' (s1, s2) [blocks, C]:
    each lane adds its K rows in order, then the tree."""
    a1 = xb.new_zeros(xb.shape[0], LANES, xb.shape[3])
    a2 = torch.zeros_like(a1)
    for k in range(xb.shape[1]):
        xk = xb[:, k]
        a1 += xk
        a2 += xk * xk
    return _tree(a1), _tree(a2)


def _padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x [r, C] with zero rows appended up to `rows`."""
    return torch.cat([x, x.new_zeros(rows - x.shape[0], x.shape[1])]) if rows > x.shape[0] else x


def bn_moments_plain(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bn_moments`: the kernel's order in torch operations."""
    n, c, h, w = y.shape
    rows = n * h * w
    if rows == 0 or c == 0:
        return y.new_zeros(c, dtype=torch.float32), y.new_zeros(c, dtype=torch.float32)
    x = y.permute(0, 2, 3, 1).reshape(rows, c).float()  # row r = pixel (n, h, w); a view in channels_last
    r = rows_per_lane(rows, c)
    block = LANES * r
    full = rows // block
    parts = []
    if full:
        parts.append(_lane_sums(x[: full * block].view(full, r, LANES, c)))
    tail = rows - full * block
    if tail:  # the last block: rows past the end add nothing, so its empty row steps are skipped
        k = -(-tail // LANES)
        parts.append(_lane_sums(_padded(x[full * block:], k * LANES).view(1, k, LANES, c)))
    out = []
    for i in (0, 1):
        p = torch.cat([s[i] for s in parts]) if len(parts) > 1 else parts[0][i]
        k = -(-p.shape[0] // LANES)
        a = p.new_zeros(LANES, c)
        for pk in _padded(p, k * LANES).view(k, LANES, c):
            a += pk
        out.append(_tree(a))
    return out[0], out[1]


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
    r = rows_per_lane(rows, c)
    blocks = -(-rows // (LANES * r))
    buf = torch.empty((2 * blocks + 2) * c, dtype=torch.float32, device=y.device)  # the partials, then s1, s2
    partials, s1, s2 = buf[: 2 * blocks * c], buf[2 * blocks * c: (2 * blocks + 1) * c], buf[(2 * blocks + 1) * c:]
    vec = route(y) == "vec"
    ext().bn_moments(y, partials, s1, s2, r, vec)
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
