"""Bytes and operations of the kernels whose roofline shares the benchmark
reads, and the H100's peaks.

The work functions are frozen copies of the system's own arithmetic
(`bmm_work`, `bn_moments_work`, `bn_moments_bwd_work`); the shape lists are
worked out here from the configuration's layer shapes through the plain
reference model on the meta device, so nothing is taken from the system.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12


def bound_s(nbytes: float, nops: float, ops_per_s: float) -> float:
    """The least seconds the work could take: the larger of its bytes over
    the memory bandwidth and its operations over `ops_per_s`."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)


def bmm_work(b: int, m: int, k: int, n: int, elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of [b, m, k] x [k, n] -> [b, m, n]."""
    return elt * (b * m * k + k * n + b * m * n), 2 * b * m * k * n


def bn_moments_work(rows: int, c: int, elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of the training BN's batch moments on [rows, C]
    (rows = N*H*W): y read once, the two fp32 [C] sums written; an add for
    s1 and a multiply and an add for s2 an element (fp32 rate)."""
    return rows * c * elt + 2 * c * 4, 3 * rows * c


def bn_moments_bwd_work(rows: int, c: int, elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of its backward on [rows, C]: y read and dy
    written, the two fp32 [C] coefficients read; 2 y, its product with g_s2
    and the sum with g_s1 an element (fp32 rate)."""
    return 2 * rows * c * elt + 2 * c * 4, 3 * rows * c


def _meta_forward(cfg: dict, imgsz: int, branches, training: bool, hook_types, hook):
    from ..reference.model import YOLOv10

    with torch.device("meta"):
        model = YOLOv10(cfg)
    model.train(training)
    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, hook_types)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, imgsz, imgsz, 3, device="meta"), branches=branches)
    finally:
        for h in handles:
            h.remove()
    return model


def serving_1x1_shapes(cfg: dict, imgsz: int) -> List[Tuple[int, int, int]]:
    """(M, K, N) per image of each 1x1 matrix product of one folded serving
    forward (the one2one branch), in call order: every dense 1x1 stride-1
    conv, the two upsample-concat convs of the top-down path split into
    their halves (the upsampled half at its own resolution, then the
    skip half), as the folded path computes them."""
    from ..reference.model import Conv, YOLOv10

    shapes, names = [], {}

    def hook(mod, args, out):
        x = args[0]
        w = mod.weight
        if tuple(w.shape[2:]) != (1, 1) or mod.stride != 1 or mod.groups != 1:
            return
        m = x.shape[2] * x.shape[3]
        split = names.get(id(mod))
        if split is None:
            shapes.append((m, w.shape[1], w.shape[0]))
        else:  # cat([upsample2x(a), b]) -> a's half at a's resolution, then b's half
            shapes.append((m // 4, split, w.shape[0]))
            shapes.append((m, w.shape[1] - split, w.shape[0]))

    with torch.device("meta"):
        model = YOLOv10(cfg)
    ch = {int(k): v for k, v in cfg["channels"].items()}
    hch = {int(k): v for k, v in cfg["neck_channels"].items()}
    names[id(model.neck.p5_p4_c2f.cv1.conv)] = ch[7]
    names[id(model.neck.p4_p3_c2f.cv1.conv)] = hch[13]
    model.eval()
    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            model(torch.zeros(1, imgsz, imgsz, 3, device="meta"), branches=("one2one",))
    finally:
        for h in handles:
            h.remove()
    return shapes


def train_bn_shapes(cfg: dict, imgsz: int, batch: int) -> List[Tuple[int, int, int, int]]:
    """[N, C, H, W] of each training-mode BatchNorm's input in one training
    forward (both head branches), in call order."""
    from ..reference.model import ConvBNAct

    shapes = []

    def hook(mod, args, out):
        shapes.append((batch, out.shape[1], out.shape[2], out.shape[3]))

    _meta_forward(cfg, imgsz, ("one2many", "one2one"), True, (ConvBNAct,), hook)
    return shapes


def bmm_bound_s(cfg: dict, imgsz: int, batch: int) -> float:
    """Seconds bmm's 1x1 products of one serving request could take at
    best, summed over its calls (bf16)."""
    return sum(bound_s(*bmm_work(batch, m, k, n), BF16_OPS_PER_S) for m, k, n in serving_1x1_shapes(cfg, imgsz))


def bn_moments_bound_s(cfg: dict, imgsz: int, batch: int) -> Tuple[float, float, int]:
    """(forward seconds, backward seconds, calls) of the training BNs' batch
    moments in one step at best (bf16 maps, fp32 arithmetic)."""
    shapes = train_bn_shapes(cfg, imgsz, batch)
    fwd = sum(bound_s(*bn_moments_work(n * h * w, c), FP32_OPS_PER_S) for n, c, h, w in shapes)
    bwd = sum(bound_s(*bn_moments_bwd_work(n * h * w, c), FP32_OPS_PER_S) for n, c, h, w in shapes)
    return fwd, bwd, len(shapes)
