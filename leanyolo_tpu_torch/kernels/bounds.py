"""Least times an H100 could take for the work of the port's kernels (bytes
over 3.35 TB/s against operations over 989 TFLOP/s bf16 or 67 TFLOP/s
fp32; each input read once, each output written once), at the shapes of the
serving and training paths and at the shapes the TPU probes ran.

    python -m leanyolo_tpu_torch.kernels.bounds

Arithmetic from shapes (and, for the NMS, a count of the IoU pairs its
data needs, `nms_pairs`): it runs anywhere and measures nothing. The
serving path's 1x1 shapes come from one forward of the folded model at
64 px on the CPU, scaled to the requested size (every map side is
imgsz / stride, so M scales with (imgsz / 64)^2).
"""

from __future__ import annotations

from typing import List, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12


def bound(nbytes: float, nops: float, ops_per_s: float = BF16_OPS_PER_S):
    """(ms, 'bytes' or 'operations') for work moving nbytes and doing nops
    operations at ops_per_s (default: bf16 on the tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def stem_work(b: int, h: int, w: int, c0: int, c1: int, in_elt: int = 1, elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of the fused stem on [b, h, w, 3] images (in_elt
    bytes a value) -> [b, h/4, w/4, c1]: the images, both convs' weights and
    biases and the output; the two dense 3x3 stride-2 convs' products."""
    h0, w0, h1, w1 = h // 2, w // 2, h // 4, w // 4
    nbytes = b * h * w * 3 * in_elt + b * h1 * w1 * c1 * elt + elt * (27 * c0 + c0 + 9 * c0 * c1 + c1)
    return nbytes, 2 * b * (h0 * w0 * c0 * 27 + h1 * w1 * c1 * 9 * c0)


def topk_work(rows: int, n: int, k: int, elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of an exact top-k over [rows, n]: the input, the
    values and int32 indices out; one key and one comparison an element
    (fp32 rate; the passes a row needs depend on its data)."""
    return rows * n * elt + rows * k * (elt + 4), rows * n


def argmax_work(rows: int, n: int, elt: int = 2, out_elt: int = 4) -> Tuple[int, int]:
    """(bytes, operations) of the per-row (max, first argmax) over [rows, n]:
    the input, a value (out_elt bytes) and an int32 index out a row; one
    comparison an element (fp32 rate)."""
    return rows * n * elt + rows * (out_elt + 4), rows * n


def argmax_flags_work(b: int, a: int, n: int, elt: int = 2, reg: int = 64) -> Tuple[int, int]:
    """(bytes, operations) of the max/argmax that also flags the maps'
    non-finite values: `argmax_work` of the [b, a, n] class maps, plus the
    [b, a, reg] reg maps read and the int32 [b, 3 n + 4] flags written; a
    comparison and a finiteness test a class value, two tests a reg bin."""
    nbytes, _ = argmax_work(b * a, n, elt)
    return nbytes + b * a * reg * elt + b * (3 * n + 4) * 4, b * a * (2 * n + 2 * reg)


DFL_SIDE_OPS = 15 + 16 * 4 + 15 + 1 + 2  # a side: the max, the subtraction, exp, product and sum a bin, den, d, box


def dfl_boxes_work(b: int, k: int, elt: int = 2, flags: bool = False, reg_max: int = 16) -> Tuple[int, int]:
    """(bytes, operations) of the selected anchors' DFL box decode (NMS
    mode): the k anchors' 4 * reg_max bins (elt bytes each) and an int32
    anchor a row in, [b, k, 4] fp32 out, with flags an image's four side
    words in; DFL_SIDE_OPS fp32 operations a side (exp counted as one)."""
    return b * k * (4 * reg_max * elt + 4 + 4 * 4) + (b * 4 * 4 if flags else 0), b * k * 4 * DFL_SIDE_OPS


def topk_decode_work(b: int, k1: int, nc: int, k: int, elt: int = 2, flags: bool = True,
                     reg_max: int = 16) -> Tuple[int, int]:
    """(bytes, operations) of the fused second top-k: stage 1's int32 [b, k1]
    anchors and their class rows of nc values (elt bytes each) in, with
    flags an image's int32 [3 nc + 4] in; the k winners' 4 * reg_max bins in
    and their [b, k, 6] fp32 rows out. One key and comparison a pair (the
    passes a row needs depend on its data), DFL_SIDE_OPS a box side and 3
    for the sigmoid a winner."""
    nbytes = b * k1 * (4 + nc * elt) + (b * (3 * nc + 4) * 4 if flags else 0) + b * k * (4 * reg_max * elt + 6 * 4)
    return nbytes, b * k1 * nc + b * k * (4 * DFL_SIDE_OPS + 3)


IOU_OPS = 14  # a pair: 4 min/max, 2 subs, 2 clamps, the product, 2 adds and a sub, the division, the compare


def nms_work(b: int, n: int, max_det: int, pairs: int = None) -> Tuple[int, int]:
    """(bytes, operations) of the greedy NMS with compaction on [b, n]
    score-sorted candidates: boxes, scores and classes in (24 bytes a
    candidate), [b, max_det, 6] fp32 and the counts out; IOU_OPS fp32
    operations a pair. `pairs`: the pairs the data needs (rows of the
    survivors against the ranks below them); default all b n(n-1)/2.

    The kernel (csrc/nms.cu) evaluates about that many pairs (`nms_pairs`),
    but its steps form a chain: n / 32 blocks of ranks, each settled only
    after the block before it, each step a barrier, the settle (a warp
    reduction a sweep) and the survivors' rows. That chain's latency, not these
    bytes or operations, sets its time; the bound does not cover it."""
    if pairs is None:
        pairs = b * n * (n - 1) // 2
    return b * n * 24 + b * max_det * 24 + b * 4, pairs * IOU_OPS


NMS_BLOCK = 32  # ranks a step of the NMS kernel's scan (csrc/nms.cu)


def nms_pairs(boxes, iou_thresh: float, valid=None, k_out: int = None) -> Tuple[int, int]:
    """(pairs the NMS kernel evaluates, pairs the data needs) on score-sorted
    candidates `boxes` [B, n, 4] (fp32 or bf16, the arithmetic's mode) with
    the keep mode's `valid` [B, n], or the compaction's k_out slots.

    Needed: each survivor's row against every rank below it (`nms_work`'s
    `pairs`). Evaluated: the diagonal blocks of the steps the kernel takes
    (the pairs inside each block of NMS_BLOCK ranks) and, at each step but
    the last, each candidate of a later block that is still alive against
    every survivor of the block. The compaction's last step is the one
    whose survivors fill the k_out slots. Counted on the plain version's
    IoUs; it measures nothing."""
    import torch

    from .nms import arithmetic_dtype, iou_matrix, nms_keep_plain, rounded

    b, n = boxes.shape[:2]
    dt = arithmetic_dtype(boxes)
    bx = boxes.to(dt)
    dev = boxes.device
    valid = torch.ones(b, n, dtype=torch.bool, device=dev) if valid is None else valid.bool()
    keep = nms_keep_plain(bx, iou_thresh, valid)
    rank = torch.arange(n, device=dev)
    needed = int(((n - 1 - rank)[None] * keep).sum())
    nb = -(-n // NMS_BLOCK)
    blk = rank // NMS_BLOCK
    kept_blk = torch.zeros(b, nb, dtype=torch.int64, device=dev).index_add_(1, blk, keep.long())
    if k_out is None:
        last = torch.full((b,), nb - 1, device=dev)
    else:  # the first block whose survivors fill the slots, else the last block
        full = kept_blk.cumsum(1) >= k_out
        last = torch.where(full.any(1), full.int().argmax(1), nb - 1)
    sizes = (n - torch.arange(nb, device=dev) * NMS_BLOCK).clamp(max=NMS_BLOCK)
    diag = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), (sizes * (sizes - 1) // 2).cumsum(0)])
    evaluated = int(diag[last + 1].sum())
    # The block of each candidate's first suppressor among the survivors.
    kills = (iou_matrix(bx) > rounded(iou_thresh, dt)) & (rank[:, None] < rank[None, :]) & keep[:, :, None]
    kill_blk = torch.where(kills.any(1), kills.int().argmax(1) // NMS_BLOCK, nb)
    # Candidate j is tested at the steps w < blk[j] and w < last while alive
    # (w <= kill_blk[j]), against every survivor of block w.
    steps = torch.minimum(torch.minimum(blk[None], last[:, None]), kill_blk + 1)
    before = torch.cat([torch.zeros(b, 1, dtype=torch.int64, device=dev), kept_blk.cumsum(1)], 1)
    return evaluated + int(torch.where(valid, before.gather(1, steps), 0).sum()), needed


def mpbwd_work(b: int, h: int, w: int, c: int, k: int = 5, elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of the k x k max-pool backward on [b, h, w, c]: x
    and dy in, dx out; one comparison per window offset per element (fp32
    rate)."""
    n = b * h * w * c
    return 3 * n * elt, k * k * n


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


# Operations of a (GT, anchor) pair of the candidates kernel, counted from
# the SASS of csrc/tal.cu's device functions as the build compiles them
# (python -m leanyolo_tpu_torch.tools.tal_pair_ops, sm_90a): the full chain
# (CIoU on the precomputed aspect angles, sigmoid, sqrt, powf, the alignment
# and its key: 46 FADD, 45 FFMA, 29 FMUL, 42 FSETP, 16 FMNMX, 7 MUFU, ...)
# and what every pair of a valid row costs (the inside test, the outside
# pair's skip test and its key). Counted as fp32 operations.
TAL_PAIR_OPS = 218
TAL_TEST_OPS = 16


def tal_work(b: int, n: int, a: int, c: int, k: int, valid: int = None, images: int = None, inside: int = None,
             part: str = None) -> Tuple[int, int]:
    """(bytes, operations) of the task-aligned assignment of [b, n] GT slots
    to [b, a] anchors of c classes with top-k k (the work does not grow with
    k), in fp32. Read once: the predicted boxes [b, a, 4] and the anchors
    [a, 2], the GT slots (box, label and mask, 21 bytes each), and every
    class logit of each image with a valid slot (`images`, default b: a NaN
    logit of any class makes the anchor's score NaN, as JAX's one-hot
    contraction does). Written once: a label and a slot (int32), a box (4
    fp32), the foreground byte and c fp32 scores an anchor. Operations: a NaN
    test a logit read, TAL_TEST_OPS a (valid slot, anchor) pair (`valid`
    slots, default b n) and TAL_PAIR_OPS a pair whose anchor lies inside
    the slot's box (`inside`, the data's count; default every valid pair);
    an outside pair's alignment is +0.0 without the chain wherever its
    inputs are finite. The CIoUs of anchors two GTs claim depend on the data
    and are not counted. part: "candidates" (the inputs and the operations)
    or "targets" (the outputs); None, both (the sum)."""
    valid = b * n if valid is None else valid
    images = b if images is None else images
    inside = valid * a if inside is None else inside
    read = (b * a * 16 + a * 8 + b * n * 21 + images * a * c * 4,
            images * a * c + valid * a * TAL_TEST_OPS + inside * TAL_PAIR_OPS)
    written = b * a * (4 + 4 + 16 + 1 + 4 * c), 0
    if part == "candidates":
        return read
    if part == "targets":
        return written
    return read[0] + written[0], read[1]


def train_bn_shapes(variant: str = "yolov10s", imgsz: int = 640, batch: int = 32) -> List[Tuple[int, int, int, int]]:
    """[N, C, H, W] of each training-mode BatchNorm input of one training
    forward (both branches, as `Trainer` runs it), in call order: spied on
    the moments wrapper in one forward at 64 px and batch 1 on the CPU,
    scaled to the requested size and batch (every map side is imgsz /
    stride)."""
    import torch

    from ..models.yolov10.model import YOLOv10
    from . import bnstats

    if imgsz % 64:
        raise ValueError("imgsz must be a multiple of 64")
    f = imgsz // 64
    model = YOLOv10.create(variant, class_names=[f"c{i}" for i in range(80)]).train()
    shapes, moments = [], bnstats.bn_moments

    def spy(y):
        shapes.append((batch, y.shape[1], y.shape[2] * f, y.shape[3] * f))
        return moments(y)

    bnstats.bn_moments = spy
    try:
        with torch.no_grad():
            model(torch.zeros(1, 64, 64, 3), dtype=torch.float32, concat_head=False)
    finally:
        bnstats.bn_moments = moments
    return shapes


def bmm_work(b: int, m: int, k: int, n: int, elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of [b, m, k] x [k, n] -> [b, m, n]."""
    return elt * (b * m * k + k * n + b * m * n), 2 * b * m * k * n


def s2dconv_work(b: int, h: int, w: int, elt: int = 2) -> Tuple[int, int]:
    """(bytes, operations) of the 3x3 32 -> 32 conv + bias + SiLU on [b, h, w, 32]:
    the map in, the map out, the [4, 128, 128] S2D weights and the bias; the
    operations of the S2D form the kernel computes (4 taps of 128 x 128 on
    each of the b * h/2 * w/2 cells; the dense conv needs 9/16 of them)."""
    cells = b * ((h + 1) // 2) * ((w + 1) // 2)
    return elt * (2 * b * h * w * 32 + 4 * 128 * 128 + 32), 2 * cells * 512 * 128


def serving_1x1_shapes(variant: str = "yolov10s", imgsz: int = 640) -> List[Tuple[int, int, int]]:
    """(M, K, N) per image of each bmm call of one folded forward of the
    serving path (the one2one branch), in call order."""
    import torch

    from ..models.yolov10.fold import fold_model
    from ..models.yolov10.model import YOLOv10
    from . import matmul

    if imgsz % 64:
        raise ValueError("imgsz must be a multiple of 64")
    model = fold_model(YOLOv10.create(variant, class_names=[f"c{i}" for i in range(80)]))
    shapes, bmm = [], matmul.bmm

    def spy(x, w, *rest):
        shapes.append((x.shape[1] * (imgsz // 64) ** 2, x.shape[2], w.shape[1]))
        return bmm(x, w, *rest)

    matmul.bmm = spy
    try:
        with torch.no_grad():
            model(torch.zeros(1, 64, 64, 3), branches=("one2one",), normalize=False, concat_head=False)
    finally:
        matmul.bmm = bmm
    return shapes


def kernel_bounds(batch: int = 32):
    """Rows of (kernel, shape, MB moved, GFLOP, bound ms, bound by) of the
    stem at each size's widths on [batch,640,640,3] uint8, the top-k pair of
    a request, the decode's argmax (alone and with the flags), fused second
    top-k and box decode (NMS mode, without and with the flags), the NMS
    (every pair, the most its data can need), mpbwd at the training path's
    SPPF shape and the batch moments (forward and
    backward) of a training step's BNs, each bounded alone, then summed."""
    from ..models.yolov10.config import VARIANTS

    rows = []
    for name, cfg in VARIANTS.items():
        nbytes, nops = stem_work(batch, 640, 640, cfg.ch[0], cfg.ch[1])
        rows.append((f"stem {name}", f"[{batch},640,640,3] u8 -> c{cfg.ch[0]},{cfg.ch[1]}", nbytes, nops,
                     *bound(nbytes, nops)))
    works = [topk_work(batch, n, 300) for n in (8400, 24000)]
    nbytes, nops = sum(w[0] for w in works), sum(w[1] for w in works)
    rows.append(("topk", f"[{batch},8400] + [{batch},24000] bf16, k=300", nbytes, nops,
                 *bound(nbytes, nops, FP32_OPS_PER_S)))
    nbytes, nops = argmax_work(batch * 8400, 80)
    rows.append(("argmax", f"[{batch},8400,80] bf16 -> fp32 + int32", nbytes, nops,
                 *bound(nbytes, nops, FP32_OPS_PER_S)))
    nbytes, nops = argmax_flags_work(batch, 8400, 80)
    rows.append(("argmax", f"[{batch},8400,80] + [{batch},8400,64] bf16, flags", nbytes, nops,
                 *bound(nbytes, nops, FP32_OPS_PER_S)))
    nbytes, nops = topk_decode_work(batch, 300, 80, 300)
    rows.append(("topk_decode", f"[{batch},300] x 80 bf16 pairs, k=300, flags", nbytes, nops,
                 *bound(nbytes, nops, FP32_OPS_PER_S)))
    for flags in (False, True):
        nbytes, nops = dfl_boxes_work(batch, 1000, flags=flags)
        rows.append(("dfl_boxes", f"[{batch},1000] bf16 reg rows, NMS mode{', flags' if flags else ''}", nbytes,
                     nops, *bound(nbytes, nops, FP32_OPS_PER_S)))
    nbytes, nops = nms_work(batch, 1000, 300)
    rows.append(("nms", f"[{batch},1000] fp32, max_det 300, every pair", nbytes, nops,
                 *bound(nbytes, nops, FP32_OPS_PER_S)))
    nbytes, nops = mpbwd_work(batch, 20, 20, 256)
    rows.append(("mpbwd", f"[{batch},20,20,256] bf16, k=5", nbytes, nops, *bound(nbytes, nops, FP32_OPS_PER_S)))
    valid = round(0.4 * 16 * batch)  # bench_train.py's draw: 40% of the slots valid, cut to the bucket of 16
    inside = valid * 24  # boxes 8-60 px a side: about 24 of the 8,400 anchor centres inside one
    for part in ("candidates", "targets"):
        nbytes, nops = tal_work(batch, 16, 8400, 80, 10, valid=valid, inside=inside, part=part)
        rows.append((f"tal_{part}", f"[{batch},16,8400] 80 classes, ~{valid} valid, a call", nbytes, nops,
                     *bound(nbytes, nops, FP32_OPS_PER_S)))
    shapes = train_bn_shapes("yolov10s", 640, batch)
    for name, work in (("bn_moments", bn_moments_work), ("bn_moments_bwd", bn_moments_bwd_work)):
        works = [work(n * h * w, c) for n, c, h, w in shapes]
        nbytes, nops = sum(w[0] for w in works), sum(w[1] for w in works)
        ms = sum(bound(nb, no, FP32_OPS_PER_S)[0] for nb, no in works)
        rows.append((name, f"{len(shapes)} BN inputs of a yolov10s 640 bf16 train step, summed", nbytes, nops, ms,
                     bound(nbytes, nops, FP32_OPS_PER_S)[1]))
    return rows


def path_bounds(batch: int = 32):
    """Rows of (kernel, shape, MB moved, GFLOP, bound ms, bound by) on the
    yolov10s 640 bf16 serving path: one s2dconv launch (two a request) and
    the sum of a request's bmm launches (each bounded alone, then summed)."""
    nbytes, nops = s2dconv_work(batch, 160, 160)
    rows = [("s2dconv", f"[{batch},160,160,32], one launch", nbytes, nops, *bound(nbytes, nops))]
    shapes = serving_1x1_shapes()
    works = [bmm_work(batch, m, k, n) for m, k, n in shapes]
    ms = sum(bound(nb, no)[0] for nb, no in works)
    by = "bytes" if sum(nb / HBM_BYTES_PER_S for nb, _ in works) >= sum(no / BF16_OPS_PER_S for _, no in works) \
        else "operations"
    rows.append(("bmm", f"{len(shapes)} 1x1 convs of a request, summed", sum(w[0] for w in works),
                 sum(w[1] for w in works), ms, by))
    return rows


def probe_bounds():
    """Rows of (kernel, shape, MB moved, GFLOP, bound ms, bound by) at the TPU probes' shapes."""
    rows = []
    # experiments/exp_pallas_k2.py (and the k2b variants): 2x2 VALID conv on
    # the space-to-depth form, x [128,81,81,128] bf16, w [4,128,128] bf16 ->
    # [128,80,80,128] bf16.
    b = 128
    nbytes = 2 * (b * 81 * 81 * 128 + 4 * 128 * 128 + b * 80 * 80 * 128)
    nops = 2 * b * 80 * 80 * 128 * (4 * 128)
    rows.append(("pallas_k2 / k2b", "[128,81,81,128] x [4,128,128]", nbytes, nops, *bound(nbytes, nops)))
    # experiments/exp_pallas_mm.py: [128,M,K] x [K,N] -> [128,M,N] bf16.
    for m, k, n in ((6400, 128, 128), (6400, 512, 128), (3200, 512, 128), (1600, 512, 128), (1600, 512, 512)):
        nbytes, nops = bmm_work(b, m, k, n)
        rows.append(("pallas_mm", f"M{m} K{k} N{n}", nbytes, nops, *bound(nbytes, nops)))
    return rows


if __name__ == "__main__":
    for name, shape, nbytes, nops, ms, by in kernel_bounds() + path_bounds() + probe_bounds():
        print(f"{name:16s} {shape:42s} {nbytes / 1e6:9.2f} MB {nops / 1e9:9.2f} GFLOP  bound {ms:.5f} ms ({by})")
