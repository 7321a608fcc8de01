"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and skip elsewhere (CUDA kernels have no CPU
mode). The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerances as in chip_smoke.py: kernel and plain version round at the same
points but sum in another order, so bf16 outputs may differ by a rounding
that lands one ulp apart: limit 4 bf16 ulps (2^-8 each) of the output's
largest magnitude; fp32 (TF32 off) to 1e-4 of it. The matrix product (bmm)
rounds once, so a flip is one ulp, at most 2^-7 of the element: limit 2
such 2^-8 units; with its fused bias and SiLU it rounds three times, as
the folded forward does: limit 4 units. The fused epilogue against the
bias-free kernel followed by PyTorch's bias add and SiLU is held to one
bf16 ulp per element: both round the same fp32 sums at the same points, but
the wgmma route's SiLU uses the hardware's approximate exp2 and reciprocal,
a few fp32 ulps from PyTorch's, which flips a bf16 rounding now and then.
Top-k, the max-pool backward (mpbwd), the fused max/argmax and the NMS
are bit-exact.
"""

from __future__ import annotations

import pytest
import torch

from leanyolo_tpu_torch import kernels
from leanyolo_tpu_torch.kernels import argmax, dwconv, matmul, mpbwd, nms, s2dconv, stem, topk
from leanyolo_tpu_torch.models.yolov10.layers import maxpool2d_same
from torch_parity import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def _limit(ref: torch.Tensor, dtype) -> float:
    scale = max(1.0, float(ref.float().abs().max()))
    return (4 * 2.0 ** -8 if dtype == torch.bfloat16 else 1e-4) * scale


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,c0,c1", [(2, 64, 96, 32, 64), (1, 128, 128, 16, 32), (32, 640, 640, 32, 64),
                                         (2, 96, 160, 32, 64), (1, 32, 32, 32, 64), (3, 64, 160, 16, 32)])
@pytest.mark.parametrize("u8", [True, False])
def test_stem_kernel(cuda_device, dtype, b, h, w, c0, c1, u8):
    """The path's shape and others, among them maps whose W/4 is not a
    multiple of the tensor-core route's 16-column tile (ragged tiles)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    img = torch.randint(0, 256, (b, h, w, 3), generator=g, device=cuda_device, dtype=torch.uint8)
    if not u8:
        img = img.to(dtype)
    ws = [torch.randn(s, generator=g, device=cuda_device).mul(sc).to(dtype)
          for s, sc in (((c0, 3, 3, 3), 0.01), ((c0,), 0.1), ((c1, c0, 3, 3), 0.1), ((c1,), 0.1))]
    ref = stem.fused_stem_plain(img, *ws, dtype=dtype)
    n, ntc = kernels.LAUNCHES["stem"], kernels.LAUNCHES["stem_tc"]
    got = stem.fused_stem(img, *ws, packed=stem.pack_weights(ws[0], ws[2]))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stem"] == n + 1
    assert kernels.LAUNCHES["stem_tc"] == ntc + (dtype == torch.bfloat16)
    assert got.shape == (b, h // 4, w // 4, c1) and got.is_contiguous()
    assert float((got.float() - ref.float()).abs().max()) <= _limit(ref, dtype)


@pytest.mark.parametrize("c0,c1", stem.WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w", [(8, 640, 640), (2, 96, 160)])
@pytest.mark.parametrize("u8", [True, False])
def test_stem_kernel_every_width(cuda_device, c0, c1, dtype, b, h, w, u8):
    """Every YOLOv10 size's stem width on both routes (conv1's weights
    resident for n/s/m, streamed through the ring for b/l/x), at 640 px and
    at a ragged map, with the weights packed once."""
    test_stem_kernel(cuda_device, dtype, b, h, w, c0, c1, u8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(32, 20, 20, 512), (2, 13, 9, 48), (1, 40, 40, 33),
                                   (2, 64, 64, 64), (1, 9, 1500, 24), (3, 2, 3, 5)])
def test_dw7x7_kernel(cuda_device, dtype, shape):
    """The path's shape (a whole map per CTA), odd channel counts (scalar
    copies), a map split into bands of rows, rows split into column blocks,
    and a map smaller than a strip."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    w = dwconv.pack_weights(torch.randn(c, 1, 7, 7, generator=g, device=cuda_device) * 0.1).to(dtype)
    b = (torch.randn(c, generator=g, device=cuda_device) * 0.1).to(dtype)
    ref = dwconv.dw7x7_bias_silu_plain(x, w, b)
    n = kernels.LAUNCHES["dw7x7"]
    got = dwconv.dw7x7_bias_silu(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dw7x7"] == n + 1
    assert float((got.float() - ref.float()).abs().max()) <= _limit(ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,n,k", [(32, 8400, 300), (32, 24000, 300), (3, 40000, 300), (5, 700, 700), (4, 50, 1)])
@pytest.mark.parametrize("canon", [True, False])
def test_topk_kernel(cuda_device, dtype, rows, n, k, canon):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn(rows, n, generator=g, device=cuda_device) * 4).round() / 4
    x[:, ::5] = -0.0
    x = x.to(dtype)
    rv, ri = topk.topk_plain(x, k, canon_zero=canon)
    gv, gi = topk.topk(x, k, canon_zero=canon)
    torch.cuda.synchronize()
    assert torch.equal(gi, ri)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(gv.view(bits), rv.view(bits))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [8400, 24000])
@pytest.mark.parametrize("k", [1, 300, 1024, 1025, 1500, "n"])
@pytest.mark.parametrize("canon", [True, False])
def test_topk_kernel_any_k(cuda_device, dtype, n, k, canon):
    """No cap on k: rank-counted winners up to 2048, a bitonic sort above
    (in shared memory, or in device memory for fp32 rows of 24000)."""
    test_topk_kernel(cuda_device, dtype, 32, n, n if k == "n" else k, canon)


def _pool_inputs(shape, dtype, ties, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    if ties:
        x = (x * 2).round() / 2  # halves: many windows hold their max twice
    return x.to(dtype), torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(32, 20, 20, 256), (3, 13, 17, 40), (2, 40, 40, 64), (1, 5, 3, 7)])
@pytest.mark.parametrize("ties", [False, True])
def test_mpbwd_kernel(cuda_device, dtype, shape, ties):
    x, dy = _pool_inputs(shape, dtype, ties, cuda_device, 3)
    ref = mpbwd.mpbwd_plain(x, dy)
    n = kernels.LAUNCHES["mpbwd"]
    got = mpbwd.mpbwd(x, dy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mpbwd"] == n + 1
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), ref.view(bits))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,k,misaligned", [((32, 20, 20, 256), 5, False), ((2, 40, 40, 64), 5, False),
                                                ((1, 70, 90, 16), 5, False), ((2, 20, 20, 48), 15, False),
                                                ((2, 11, 13, 24), 3, False), ((3, 13, 17, 33), 5, False),
                                                ((2, 20, 20, 64), 5, True)])
def test_mpbwd_kernel_routes(cuda_device, dtype, shape, k, misaligned):
    """Both routes, chosen by shape: the 16-byte route (whole maps and maps
    split into tiles, several k), and the general route for a C that holds
    no whole 16-byte vector or tensors off a 16-byte boundary."""
    x, dy = _pool_inputs(shape, dtype, True, cuda_device, 12)
    if misaligned:  # the same values one element into a buffer
        x, dy = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(shape) for t in (x, dy))
    vec = shape[-1] % (16 // x.element_size()) == 0 and not misaligned
    assert mpbwd.route(x, dy, torch.empty_like(x)) == ("vec" if vec else "general")
    n, nv = kernels.LAUNCHES["mpbwd"], kernels.LAUNCHES["mpbwd_vec"]
    got = mpbwd.mpbwd(x, dy, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mpbwd"] == n + 1 and kernels.LAUNCHES["mpbwd_vec"] == nv + vec
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), mpbwd.mpbwd_plain(x, dy, k).view(bits))


@pytest.mark.parametrize("k", [3, 7])
def test_mpbwd_kernel_other_k(cuda_device, k):
    x, dy = _pool_inputs((2, 20, 20, 48), torch.float32, True, cuda_device, 4)
    got = mpbwd.mpbwd(x, dy, k)
    torch.cuda.synchronize()
    assert torch.equal(got, mpbwd.mpbwd_plain(x, dy, k))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_maxpool_autograd_uses_the_kernel(cuda_device, dtype):
    x, dy = _pool_inputs((4, 20, 20, 64), dtype, True, cuda_device, 5)
    xc = x.permute(0, 3, 1, 2).requires_grad_()  # channels_last NCHW view, as in the model
    n = kernels.LAUNCHES["mpbwd"]
    y = maxpool2d_same(xc, 5)
    y.backward(dy.permute(0, 3, 1, 2))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mpbwd"] == n + 1
    assert torch.equal(y, torch.nn.functional.max_pool2d(xc.detach(), 5, 1, 2))
    ref = mpbwd.mpbwd_plain(x, dy).permute(0, 3, 1, 2)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(xc.grad.contiguous().view(bits), ref.contiguous().view(bits))


def _nhwc(shape, sliced, dtype, g, device):
    """A random [B,H,W,C] map; sliced: the upper half of a map twice as wide,
    read in place as the model's channel slices are."""
    b, h, w, c = shape
    x = torch.randn(b, h, w, 2 * c if sliced else c, generator=g, device=device)
    return (x[..., c:] if sliced else x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,sliced", [((32, 160, 160, 32), True), ((2, 14, 18, 32), False),
                                          ((3, 9, 7, 32), False), ((1, 2, 2, 32), True)])
def test_s2dconv_kernel(cuda_device, dtype, shape, sliced):
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = _nhwc(shape, sliced, dtype, g, cuda_device)
    w = s2dconv.pack_weights(torch.randn(32, 32, 3, 3, generator=g, device=cuda_device) * 0.1).to(dtype)
    b = (torch.randn(32, generator=g, device=cuda_device) * 0.1).to(dtype)
    ref = s2dconv.conv3x3_c32_bias_silu_plain(x, w, b)
    n, nw = kernels.LAUNCHES["s2dconv"], kernels.LAUNCHES["s2dconv_wgmma"]
    got = s2dconv.conv3x3_c32_bias_silu(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["s2dconv"] == n + 1
    assert kernels.LAUNCHES["s2dconv_wgmma"] == nw + (dtype == torch.bfloat16)
    assert got.shape == shape and got.is_contiguous()
    assert float((got.float() - ref.float()).abs().max()) <= _limit(ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("taps", [s2dconv.TAPS, ((0, 0),) * 4, ((1, 1), (0, 1), (1, 0), (0, 0))])
def test_s2dconv_kernel_any_taps_and_weights(cuda_device, dtype, taps):
    """Dense [4,128,128] weights (no zero blocks) and other tap tables, as
    the TPU kernel bodies take them."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(4, 20, 24, 32, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(4, 128, 128, generator=g, device=cuda_device) * 0.05).to(dtype)
    b = (torch.randn(32, generator=g, device=cuda_device) * 0.1).to(dtype)
    ref = s2dconv.conv3x3_c32_bias_silu_plain(x, w, b, taps)
    nw = kernels.LAUNCHES["s2dconv_wgmma"]
    got = s2dconv.conv3x3_c32_bias_silu(x, w, b, taps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["s2dconv_wgmma"] == nw + (dtype == torch.bfloat16)
    assert float((got.float() - ref.float()).abs().max()) <= _limit(ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,m,k,n,sliced", [(32, 25600, 64, 64, False), (32, 6400, 192, 128, False),
                                            (32, 400, 1024, 512, False), (32, 400, 128, 80, False),
                                            (3, 100, 96, 40, True), (2, 37, 75, 33, False), (1, 1, 8, 8, False)])
def test_bmm_kernel(cuda_device, dtype, b, m, k, n, sliced):
    """bf16 with K and N multiples of 8 takes the wgmma route (K = 64: one
    stage; N = 80: the cls conv's tile; M not a multiple of 128; a channel
    slice read in place; K = 1024, N = 512); fp32 and the odd bf16 shape
    [2,37,75]x[75,33] take mma.sync."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    x = _nhwc((b, 1, m, k), sliced, dtype, g, cuda_device)[:, 0]  # [b, m, k], rows k or 2k apart
    w = (torch.randn(k, n, generator=g, device=cuda_device) / k ** 0.5).to(dtype)
    ref = matmul.bmm_plain(x, w)
    n0, nw = kernels.LAUNCHES["bmm"], kernels.LAUNCHES["bmm_wgmma"]
    got = matmul.bmm(x, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bmm"] == n0 + 1
    wgmma = dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
    assert kernels.LAUNCHES["bmm_wgmma"] == nw + wgmma
    assert got.shape == (b, m, n) and got.dtype == dtype
    scale = max(1.0, float(ref.float().abs().max()))
    limit = (2 * 2.0 ** -8 if dtype == torch.bfloat16 else 1e-4) * scale
    assert float((got.float() - ref.float()).abs().max()) <= limit


def _bf16_ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per element, how many bf16 steps lie between a and b (+0 == -0)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("b,m,k,n", [(8, 400, 256, 512), (4, 1600, 128, 80), (2, 37, 75, 33)])
def test_bmm_kernel_fused_epilogue(cuda_device, dtype, act, b, m, k, n):
    """bias (+ SiLU) in the epilogue: against the plain version with the same
    arguments, and against the bias-free kernel + PyTorch's bias and SiLU."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(b, m, k, generator=g, device=cuda_device).to(dtype)
    w = (torch.randn(k, n, generator=g, device=cuda_device) / k ** 0.5).to(dtype)
    bias = torch.randn(n, generator=g, device=cuda_device).to(dtype)
    ref = matmul.bmm_plain(x, w, bias, act)
    got = matmul.bmm(x, w, bias, act)
    base = matmul.bmm(x, w) + bias
    unfused = torch.nn.functional.silu(base) if act else base
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((got.float() - ref.float()).abs().max()) <= (4 * 2.0 ** -8 if dtype == torch.bfloat16 else 1e-4) * scale
    if dtype == torch.bfloat16:
        assert int(_bf16_ulps_apart(got, unfused).max()) <= 1
    else:
        assert float((got - unfused).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("rows,n", [(200 * 128, 64), (300 * 128, 128), (100 * 128, 256)])
def test_bmm_kernel_one_and_two_consumer_pairs(cuda_device, rows, n):
    """Both consumer layouts of the wgmma route (two pairs where a CTA gets
    two tiles or more), with bias and SiLU."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(1, rows, 192, generator=g, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn(192, n, generator=g, device=cuda_device) / 192 ** 0.5).to(torch.bfloat16)
    bias = torch.randn(n, generator=g, device=cuda_device).to(torch.bfloat16)
    got = matmul.bmm(x, w, bias, True)
    ref = matmul.bmm_plain(x, w, bias, True)
    torch.cuda.synchronize()
    assert float((got.float() - ref.float()).abs().max()) <= 4 * 2.0 ** -8 * max(1.0, float(ref.float().abs().max()))


def test_bmm_kernel_upcat_half_in_place(cuda_device):
    """Rows lo:hi of a K-major [Cin, Cout] view (an upsample-concat conv's
    half, as MatmulConv packs it) go to the wgmma route with no copy."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    wt = (torch.randn(192, 384, generator=g, device=cuda_device) * 0.05).to(torch.bfloat16).t()  # [384, 192]
    for lo, hi in ((0, 256), (256, 384)):
        half = wt[lo:hi]
        assert matmul._k_major(half) is half
        x = torch.randn(2, 300, hi - lo, generator=g, device=cuda_device).to(torch.bfloat16)
        nw = kernels.LAUNCHES["bmm_wgmma"]
        got = matmul.bmm(x, half)
        ref = matmul.bmm_plain(x, half)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["bmm_wgmma"] == nw + 1
        assert float((got.float() - ref.float()).abs().max()) <= 2 * 2.0 ** -8 * max(1.0, float(ref.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_folded_model_launches_the_new_kernels(cuda_device, dtype):
    """The folded yolov10s forward on the card: 1 stem, 2 s2dconv and 45 bmm
    launches (bf16 on the tensor-core and wgmma routes), and head maps that
    match the all-plain forward."""
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.models.yolov10.fold import fold_model

    model = YOLOv10.create("yolov10s", class_names=[f"c{i}" for i in range(80)], seed=0)
    folded = fold_model(model, dtype=dtype).to(cuda_device, memory_format=torch.channels_last).eval()
    imgs = torch.randint(0, 256, (2, 128, 128, 3), device=cuda_device, dtype=torch.uint8)
    kw = dict(dtype=dtype, branches=("one2one",), normalize=False, concat_head=False)
    kernels.reset_launches()
    with torch.no_grad():
        got = folded(imgs, **kw)["one2one"]
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["s2dconv"] == 2 and kernels.LAUNCHES["bmm"] == 45 and kernels.LAUNCHES["stem"] == 1
        bf16 = dtype == torch.bfloat16
        assert kernels.LAUNCHES["bmm_wgmma"] == (45 if bf16 else 0)
        assert kernels.LAUNCHES["s2dconv_wgmma"] == (2 if bf16 else 0)
        assert kernels.LAUNCHES["stem_tc"] == (1 if bf16 else 0)
        bmm, conv3 = matmul.bmm, s2dconv.conv3x3_c32_bias_silu
        matmul.bmm, s2dconv.conv3x3_c32_bias_silu = matmul.bmm_plain, s2dconv.conv3x3_c32_bias_silu_plain
        try:
            ref = folded(imgs, **kw)["one2one"]
        finally:
            matmul.bmm, s2dconv.conv3x3_c32_bias_silu = bmm, conv3
    for lg, lr in zip(got, ref):
        for a, r in zip(lg, lr):
            scale = max(1.0, float(r.float().abs().max()))
            # bf16: a one-ulp flip in a conv travels through the rest of the
            # net; fp32 differs in the order of sums only.
            assert float((a.float() - r.float()).abs().max()) <= (0.1 if dtype == torch.bfloat16 else 1e-3) * scale


@pytest.mark.parametrize("variant", ["yolov10m", "yolov10b", "yolov10l", "yolov10x"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_folded_variant_serves_on_the_card(cuda_device, variant, dtype):
    """A folded yolov10m/b/l/x serves through Predictor on the card with its
    stem on the kernel of its dtype, and its head maps match the all-plain
    forward (tolerances as for yolov10s above)."""
    import numpy as np
    from leanyolo_tpu_torch import Predictor, YOLOv10

    model = YOLOv10.create(variant, class_names=[f"c{i}" for i in range(80)], seed=0)
    pred = Predictor(model, imgsz=128, decode="topk", dtype=dtype, fuse=True)
    imgs = np.random.RandomState(0).randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    kernels.reset_launches()
    dets, num = pred.run_batch(imgs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stem"] == 1 and kernels.LAUNCHES["stem_tc"] == (dtype == "bfloat16")
    assert kernels.LAUNCHES["topk"] == 2 and tuple(dets.shape) == (2, 300, 6) and bool(torch.isfinite(dets).all())
    got = pred.raw(imgs)
    saved = stem.fused_stem, matmul.bmm, dwconv.dw7x7_bias_silu, topk.topk
    stem.fused_stem = lambda *a, dtype=None, packed=None: stem.fused_stem_plain(*a, dtype=dtype or a[1].dtype)
    matmul.bmm, dwconv.dw7x7_bias_silu, topk.topk = matmul.bmm_plain, dwconv.dw7x7_bias_silu_plain, topk.topk_plain
    try:
        ref = pred.raw(imgs)
    finally:
        stem.fused_stem, matmul.bmm, dwconv.dw7x7_bias_silu, topk.topk = saved
    for lg, lr in zip(got, ref):
        for a, r in zip(lg, lr):
            scale = max(1.0, float(r.float().abs().max()))
            assert float((a.float() - r.float()).abs().max()) <= (0.1 if dtype == "bfloat16" else 1e-3) * scale


def test_wrappers_raise_on_unsupported(cuda_device):
    ws = [torch.zeros(s, device=cuda_device) for s in ((32, 3, 3, 3), (32,), (64, 32, 3, 3), (64,))]
    with pytest.raises(ValueError):
        stem.fused_stem(torch.zeros(1, 48, 64, 3, dtype=torch.uint8, device=cuda_device), *ws)
    with pytest.raises(ValueError):  # bf16 weights not packed
        stem.fused_stem(torch.zeros(1, 64, 64, 3, dtype=torch.uint8, device=cuda_device),
                        *[t.bfloat16() for t in ws])
    with pytest.raises(ValueError):
        dwconv.dw7x7_bias_silu(torch.zeros(1, 8, 8, 4, device=cuda_device).permute(0, 2, 1, 3),
                               torch.zeros(49, 4, device=cuda_device), torch.zeros(4, device=cuda_device))
    with pytest.raises(ValueError):  # weights not packed as [49, C]
        dwconv.dw7x7_bias_silu(torch.zeros(1, 8, 8, 4, device=cuda_device),
                               torch.zeros(4, 1, 7, 7, device=cuda_device), torch.zeros(4, device=cuda_device))
    with pytest.raises(ValueError):
        topk.topk(torch.zeros(2, 10, dtype=torch.float16, device=cuda_device), 3, canon_zero=True)
    with pytest.raises(ValueError):
        mpbwd.mpbwd(torch.zeros(1, 8, 8, 4, device=cuda_device), torch.zeros(1, 8, 8, 4, device=cuda_device), 4)
    with pytest.raises(ValueError):
        s2dconv.conv3x3_c32_bias_silu(torch.zeros(1, 8, 8, 16, device=cuda_device),
                                      torch.zeros(4, 128, 128, device=cuda_device), torch.zeros(32, device=cuda_device))
    with pytest.raises(ValueError):
        matmul.bmm(torch.zeros(1, 8, 4, dtype=torch.float16, device=cuda_device),
                   torch.zeros(4, 4, dtype=torch.float16, device=cuda_device))
    x, w = torch.zeros(1, 8, 16, device=cuda_device), torch.zeros(16, 8, device=cuda_device)
    with pytest.raises(ValueError):  # bias not [N]
        matmul.bmm(x, w, torch.zeros(9, device=cuda_device), True)
    with pytest.raises(ValueError):  # bias on the CPU
        matmul.bmm(x.bfloat16(), w.bfloat16(), torch.zeros(8), True)


def argmax_rows(g, shape, dtype, device):
    """Coarse values (repeated maxima) with rows of signed zeros: all -0.0,
    -0.0 before +0.0, and negative rows whose max is a zero."""
    x = (torch.randn(shape, generator=g, device=device) * 2).round() / 2
    r = x.shape[-2]
    x[..., : r // 8, :] = 0.0
    x[..., : r // 8, ::3] = -0.0
    x[..., r // 8: r // 4, :] = -x[..., r // 8: r // 4, :].abs() - 1.0
    x[..., r // 8: r // 4, 7] = -0.0
    x[..., r // 8: r // 4, 11] = 0.0
    x[..., r // 4: r // 4 + 2, :] = -0.0
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("canon", [True, False])
@pytest.mark.parametrize("b,n,sliced", [(4, 80, False), (4, 80, True), (2, 37, False), (3, 1000, False)])
def test_argmax_kernel(cuda_device, dtype, canon, b, n, sliced):
    """The three levels of a 640 px map in one launch (16-byte loads), the
    class slice of a concatenated head map read in place, an n that holds
    no whole 16-byte vector (scalar loads), and a long row."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    levels = []
    for hw in (6400, 1600, 400):
        x = argmax_rows(g, (b, hw, n + (64 if sliced else 0)), dtype, cuda_device)
        levels.append(x[..., 64:] if sliced else x)
    n0 = kernels.LAUNCHES["argmax"]
    gv, gi = argmax.max_argmax_levels(levels, canon_zero=canon)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["argmax"] == n0 + 1
    rv, ri = argmax.max_argmax_levels([t.cpu() for t in levels], canon_zero=canon)
    assert gv.dtype == rv.dtype == (dtype if canon else torch.float32)
    assert torch.equal(gi.cpu(), ri)
    bits = torch.int16 if gv.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(gv.cpu().view(bits), rv.view(bits))
    pv, pi = argmax.max_argmax_plain(torch.cat(levels, dim=1), canon_zero=canon)  # the plain version on the card
    assert torch.equal(gi, pi) and torch.equal(gv.view(bits), pv.view(bits))


def nms_inputs(g, b, n, device, grid):
    """Score-sorted candidates: boxes on an integer grid (IoUs exactly at
    0.5, 1/3, ...) or spread, scores descending with ties, classes 0..79."""
    if grid:
        xy = torch.randint(0, 8, (b, n, 2), generator=g, device=device).float()
        wh = torch.randint(1, 5, (b, n, 2), generator=g, device=device).float()
    else:
        xy = torch.rand(b, n, 2, generator=g, device=device) * 600
        wh = torch.rand(b, n, 2, generator=g, device=device) * 120 + 4
    boxes = torch.cat([xy, xy + wh], dim=-1).contiguous()
    scores = ((torch.rand(b, n, generator=g, device=device) * 64).round() / 64).sort(dim=1, descending=True).values
    cls = torch.randint(0, 80, (b, n), generator=g, device=device).float()
    return boxes, scores.contiguous(), cls


# Images a launch: 1, 3 and 32 take clusters of 8, 8 and 4 CTAs an image on
# 132 SMs (each CTA tests the candidates of every cl-th word of 32 ranks), 66
# clusters of 2 and 140 one CTA an image, in two waves.
NMS_BATCHES = [1, 3, 32, 66, 140]
# Ranks around the blocks of 32 the kernel walks, the path's 1000 and 1500.
NMS_SIZES = [1, 31, 32, 33, 63, 65, 1000, 1500]


@pytest.mark.parametrize("b", NMS_BATCHES)
@pytest.mark.parametrize("n", NMS_SIZES)
@pytest.mark.parametrize("grid,thresh", [(True, 0.5), (False, 0.45), (False, 0.65)])
@pytest.mark.parametrize("with_valid", [True, False])
def test_nms_keep_kernel(cuda_device, b, n, grid, thresh, with_valid):
    """The keep mask, bit-equal to the plain version, at every cluster
    size and at block edges."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    boxes, _, _ = nms_inputs(g, b, n, cuda_device, grid)
    valid = torch.rand(b, n, generator=g, device=cuda_device) < 0.7 if with_valid else None
    n0 = kernels.LAUNCHES["nms"]
    got = nms.nms_keep(boxes, thresh, valid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["nms"] == n0 + 1
    ref = nms.nms_keep_plain(boxes, thresh, valid)
    assert got.dtype == torch.bool and torch.equal(got, ref)


@pytest.mark.parametrize("b", NMS_BATCHES)
@pytest.mark.parametrize("n", NMS_SIZES)
@pytest.mark.parametrize("class_wise", [True, False])
@pytest.mark.parametrize("conf,iou,max_det", [(0.25, 0.45, 300), (0.001, 0.65, 300), (0.001, 0.65, 20),
                                              (0.001, 0.65, 1)])
def test_nms_compact_kernel(cuda_device, b, n, class_wise, conf, iou, max_det):
    """The decode's NMS with its compaction, bit-equal to the plain version
    (dets and num), class-wise and not, at the inference and the validator's
    thresholds, with max_det below the survivors (the kernel stops once the
    slots are filled)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    boxes, scores, cls = nms_inputs(g, b, n, cuda_device, False)
    gd, gn = nms.nms_compact(boxes, scores, cls, iou_thresh=iou, conf_thresh=conf, max_det=max_det,
                             class_wise=class_wise)
    rd, rn = nms.nms_compact_plain(boxes, scores, cls, iou_thresh=iou, conf_thresh=conf, max_det=max_det,
                                   class_wise=class_wise)
    torch.cuda.synchronize()
    assert gd.shape == (b, max_det, 6) and gn.dtype == torch.int32
    assert torch.equal(gn, rn) and torch.equal(gd, rd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [10_000, 12_000])
def test_nms_many_candidates_kernel(cuda_device, dtype, n):
    """n = 10,000 (the boxes still in shared memory) and 12,000 (read from
    device memory), one image: keep masks and the compaction."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    for grid, thresh in ((True, 0.5), (False, 0.45)):
        boxes, scores, cls = (t.to(dtype) for t in nms_inputs(g, 1, n, cuda_device, grid))
        valid = torch.rand(1, n, generator=g, device=cuda_device) < 0.7
        assert torch.equal(nms.nms_keep(boxes, thresh, valid), nms.nms_keep_plain(boxes, thresh, valid))
    kw = dict(iou_thresh=0.65, conf_thresh=0.001, max_det=n, class_wise=True)
    gd, gn = nms.nms_compact(boxes, scores, cls, **kw)
    rd, rn = nms.nms_compact_plain(boxes, scores, cls, **kw)
    torch.cuda.synchronize()
    assert torch.equal(gn, rn) and torch.equal(gd, rd)


def edge_blocks(device, dtype):
    """65 ranks: rank 0, 30 disjoint boxes and a last survivor at rank 31
    (block 0's last rank), then a block whose 32 candidates all lie under
    rank 0, then one survivor in block 2; classes 0 and 79 in turn."""
    base = [[0, 0, 10, 10]]
    apart = [[100 + 20 * i, 100, 110 + 20 * i, 110] for i in range(30)]
    boxes = torch.tensor(base + apart + [[100, 500, 110, 510]] + base * 32 + [[100, 900, 110, 910]],
                         device=device, dtype=torch.float32)
    n = boxes.shape[0]
    scores = torch.linspace(0.9, 0.3, n, device=device)
    cls = torch.tensor([0.0, 79.0], device=device).repeat(n)[:n]
    return (t[None].to(dtype).contiguous() for t in (boxes, scores, cls))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 140])
def test_nms_block_edges_kernel(cuda_device, dtype, b):
    """A block whose candidates are all suppressed, a survivor at a
    block's last rank, and (class-wise) classes 0 and 79 shifting the same
    boxes apart: keep and compaction bit-equal to the plain version."""
    boxes, scores, cls = (t.expand(b, -1, -1).contiguous() if t.dim() == 3 else t.expand(b, -1).contiguous()
                          for t in edge_blocks(cuda_device, dtype))
    keep = nms.nms_keep(boxes, 0.45)
    assert torch.equal(keep, nms.nms_keep_plain(boxes, 0.45))
    assert keep[:, 31].all() and not keep[:, 32:64].any() and keep[:, 64].all()
    for class_wise in (False, True):
        for max_det in (1, 20, 300):
            kw = dict(iou_thresh=0.45, conf_thresh=0.25, max_det=max_det, class_wise=class_wise)
            gd, gn = nms.nms_compact(boxes, scores, cls, **kw)
            rd, rn = nms.nms_compact_plain(boxes, scores, cls, **kw)
            torch.cuda.synchronize()
            assert torch.equal(gn, rn) and torch.equal(gd, rd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_det", [1, 20, 300])
def test_nms_compact_stops_early_kernel(cuda_device, dtype, max_det):
    """The compaction's early stop, class-wise with classes 0 and 79 only,
    in both arithmetic modes, at 32 images."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    boxes, scores, cls = nms_inputs(g, 32, 1000, cuda_device, False)
    cls = (cls >= 40).float() * 79
    boxes, scores, cls = (t.to(dtype) for t in (boxes, scores, cls))
    kw = dict(iou_thresh=0.65, conf_thresh=0.001, max_det=max_det, class_wise=True)
    gd, gn = nms.nms_compact(boxes, scores, cls, **kw)
    rd, rn = nms.nms_compact_plain(boxes, scores, cls, **kw)
    torch.cuda.synchronize()
    assert torch.equal(gn, rn) and torch.equal(gd, rd)
    assert int(gn.min()) == max_det  # every image filled its slots


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_dead_bits_in_device_memory_kernel(cuda_device, dtype):
    """n = 2^21, past the dead bits shared memory holds: two disjoint boxes
    in turn, half of them valid; the first valid of each survives."""
    n = 1 << 21
    g = torch.Generator(device=cuda_device).manual_seed(11)
    pair = torch.tensor([[0.0, 0.0, 10.0, 10.0], [100.0, 100.0, 110.0, 110.0]], device=cuda_device)
    rank = torch.arange(n, device=cuda_device)
    boxes = pair[rank % 2][None].to(dtype).contiguous()
    valid = torch.rand(1, n, generator=g, device=cuda_device) < 0.5
    keep = nms.nms_keep(boxes, 0.5, valid)
    torch.cuda.synchronize()
    firsts = [int(rank[valid[0] & (rank % 2 == p)][0]) for p in (0, 1)]
    assert int(keep.sum()) == 2 and keep[0, firsts].all()


def test_new_wrappers_route_by_device(cuda_device, monkeypatch):
    """A CPU tensor never reaches the kernels; a CUDA tensor never reaches
    the plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    boxes, scores, cls = nms_inputs(g, 2, 100, cuda_device, False)
    x = argmax_rows(g, (2, 64, 80), torch.bfloat16, cuda_device)
    counts = dict(kernels.LAUNCHES)
    argmax.max_argmax_levels([x.cpu()], canon_zero=True)
    nms.nms_keep(boxes.cpu(), 0.5)
    nms.nms_compact(boxes.cpu(), scores.cpu(), cls.cpu(), iou_thresh=0.5, conf_thresh=0.1, max_det=10,
                    class_wise=True)
    assert kernels.LAUNCHES == counts

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((argmax, "max_argmax_plain"), (nms, "nms_keep_plain"), (nms, "nms_compact_plain"),
                      (nms, "compact_plain")):
        monkeypatch.setattr(mod, name, refuse)
    argmax.max_argmax_levels([x], canon_zero=True)
    nms.nms_keep(boxes, 0.5)
    nms.nms_compact(boxes, scores, cls, iou_thresh=0.5, conf_thresh=0.1, max_det=10, class_wise=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["argmax"] == counts["argmax"] + 1 and kernels.LAUNCHES["nms"] == counts["nms"] + 2
    with pytest.raises(ValueError):
        nms.nms_keep(boxes.double(), 0.5)
    with pytest.raises(ValueError):
        argmax.max_argmax_levels([x.half()], canon_zero=False)


@pytest.mark.parametrize("presorted", [True, False])
def test_nms_fixed_on_the_card(cuda_device, presorted):
    """`nms_fixed` on card tensors runs the kernel's keep mode once and
    gives the keep set of the CPU's blocked substitution."""
    from leanyolo_tpu_torch.ops.boxes import nms_fixed

    g = torch.Generator(device=cuda_device).manual_seed(7)
    boxes, scores, _ = nms_inputs(g, 1, 500, cuda_device, True)
    if not presorted:
        scores = scores[:, torch.randperm(500, generator=g, device=cuda_device)]
    valid = torch.rand(500, generator=g, device=cuda_device) < 0.7
    n0 = kernels.LAUNCHES["nms"]
    got = nms_fixed(boxes[0], scores[0], 0.5, block=7, presorted=presorted, valid=valid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["nms"] == n0 + 1
    ref = nms_fixed(boxes[0].cpu(), scores[0].cpu(), 0.5, block=7, presorted=presorted, valid=valid.cpu())
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_predictor_nms_on_the_card(cuda_device, dtype, monkeypatch):
    """Predictor(decode="nms") on the card: one argmax, one top-k and one NMS
    launch a request, and the decode bit-equal to the decode with every
    kernel replaced by its plain version, on the same head maps on the card."""
    from leanyolo_tpu_torch import Predictor, YOLOv10
    from leanyolo_tpu_torch.models.yolov10.decode import decode_nms

    model = YOLOv10.create("yolov10n", class_names=[f"c{i}" for i in range(80)], seed=0)
    pred = Predictor(model, imgsz=320, decode="nms", dtype=dtype, fuse=True, conf_thresh=0.001, iou_thresh=0.65)
    imgs = torch.randint(0, 256, (2, 320, 320, 3), dtype=torch.uint8, device=cuda_device)
    kernels.reset_launches()
    dets, num = pred.run_batch(imgs)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["argmax"], kernels.LAUNCHES["topk"], kernels.LAUNCHES["nms"]) == (1, 1, 1)
    assert dets.shape == (2, 300, 6) and num.shape == (2,)
    raw = pred.raw(imgs)
    kw = dict(num_classes=80, conf_thresh=0.001, iou_thresh=0.65, rank_dtype=torch.float32)
    got = decode_nms(raw, **kw)
    monkeypatch.setattr(argmax, "max_argmax_levels", argmax.max_argmax_levels_plain)
    monkeypatch.setattr(topk, "topk", topk.topk_plain)
    monkeypatch.setattr(nms, "nms_compact", nms.nms_compact_plain)
    n0 = dict(kernels.LAUNCHES)
    ref = decode_nms(raw, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == n0
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("b", NMS_BATCHES)
@pytest.mark.parametrize("n", [31, 33, 63, 1000, 1500])
@pytest.mark.parametrize("thresh", [0.45, 0.451])
def test_nms_bf16_mode_kernel(cuda_device, b, n, thresh):
    """K5's bf16 arithmetic mode (bf16 candidates): keep masks and the
    compaction bit-equal to the plain version's bf16 arithmetic."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    boxes, scores, cls = (t.bfloat16() for t in nms_inputs(g, b, n, cuda_device, False))
    valid = torch.rand(b, n, generator=g, device=cuda_device) < 0.7
    assert torch.equal(nms.nms_keep(boxes, thresh, valid), nms.nms_keep_plain(boxes, thresh, valid))
    for class_wise in (False, True):
        kw = dict(iou_thresh=thresh, conf_thresh=0.25, max_det=300, class_wise=class_wise)
        gd, gn = nms.nms_compact(boxes, scores, cls, **kw)
        rd, rn = nms.nms_compact_plain(boxes, scores, cls, **kw)
        torch.cuda.synchronize()
        assert gd.dtype == torch.float32 and torch.equal(gn, rn) and torch.equal(gd, rd)


def test_decode_direct_nms_bf16_on_the_card(cuda_device, monkeypatch):
    from leanyolo_tpu_torch.models.yolov10.decode import decode_direct_nms

    g = torch.Generator(device=cuda_device).manual_seed(9)
    maps = [torch.cat([torch.randn(4, h, h, 4, generator=g, device=cuda_device) * 0.5,
                       (torch.randn(4, h, h, 80, generator=g, device=cuda_device) * 3 - 4)], -1).bfloat16()
            for h in (16, 8, 4)]
    kw = dict(num_classes=80, strides=(8, 16, 32), conf_thresh=0.05, iou_thresh=0.45, max_det=100)
    before = kernels.LAUNCHES["nms"]
    gd, gn = decode_direct_nms(maps, **kw)
    assert kernels.LAUNCHES["nms"] == before + 1
    monkeypatch.setattr(argmax, "max_argmax_levels", argmax.max_argmax_levels_plain)
    monkeypatch.setattr(topk, "topk", topk.topk_plain)
    monkeypatch.setattr(nms, "nms_compact", nms.nms_compact_plain)
    rd, rn = decode_direct_nms(maps, **kw)
    torch.cuda.synchronize()
    assert torch.equal(gn, rn) and torch.equal(gd, rd) and int(gn.min()) > 0


@pytest.mark.parametrize("decode", ["topk", "nms"])
def test_serving_export_on_the_card(cuda_device, tmp_path, decode):
    """A yolov10n bf16 artifact exported on the card at a symbolic batch,
    saved and loaded: bit-equal to the live module at batches 1 and 3, with
    each serving kernel launched per call (the packed weights travel in the
    artifact: the bf16 stem route raises without them)."""
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.export import serving as S

    model = YOLOv10.create("yolov10n", class_names=[f"c{i}" for i in range(80)], seed=0)
    path = S.export_serving(model, str(tmp_path / "a"), imgsz=64, decode=decode, dtype="bf16", max_dets=50)
    art = S.load_exported(path)
    fn, _ = S.build_serving_fn(model, imgsz=64, decode=decode, dtype="bf16", max_dets=50)
    g = torch.Generator(device=cuda_device).manual_seed(10)
    for b in (1, 3):
        x = torch.rand(b, 64, 64, 3, generator=g, device=cuda_device) * 255
        kernels.reset_launches()
        got = art(x)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["stem_tc"] == 1 and kernels.LAUNCHES["bmm"] > 0 and kernels.LAUNCHES["topk"] == 1
        assert kernels.LAUNCHES["nms" if decode == "nms" else "argmax"] == 1
        with torch.no_grad():
            ref = fn(x)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
