"""The fused stem's packed weights and the GEMMs the tensor-core kernel runs
on them (kernels/stem.py, csrc/stem.cu) against the plain stem and the JAX
package's Pallas stem.

The CUDA kernel runs only on the card (tests/test_torch_kernels_cuda.py);
here `stem_gemm` repeats its data flow in PyTorch: the input as bf16 pixel
pairs, conv0 as 3 k16 steps a pixel (one kernel row each, K padded with
zero weights), conv1 as 9 taps x c0/16 k16 steps over the conv0
activations with conv1's zero padding, each B matrix read back from the
packed fragments. It proves the packing and the K layout the kernel's
ldmatrix addresses assume.

Tolerances: fp32 < 5e-4 of the output's scale (sums in another order);
bf16 4 bf16 ulps (2^-8 each) of the output's largest magnitude, the gap
`tests/test_torch_kernels_ref.py` holds the plain stem to (the Pallas stem
rounds once, the port at the folded forward's three points).
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leanyolo_tpu_torch import YOLOv10, kernels
from leanyolo_tpu_torch.kernels import stem
from leanyolo_tpu_torch.models.yolov10.fold import fold_model
from torch_parity import as_f32, bf16_ulps

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments"))

WIDTHS = list(stem.WIDTHS)
KERNELS_H = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "leanyolo_tpu_torch", "kernels", "csrc", "kernels.h")


def _weights(rng, c0, c1):
    """OIHW stem weights at a folded net's scale (conv0 has the /255 folded in)."""
    w0 = torch.from_numpy((rng.randn(c0, 3, 3, 3) * 0.5 / 255).astype(np.float32))
    b0 = torch.from_numpy((rng.randn(c0) * 0.1).astype(np.float32))
    w1 = torch.from_numpy((rng.randn(c1, c0, 3, 3) * 0.1).astype(np.float32))
    b1 = torch.from_numpy((rng.randn(c1) * 0.1).astype(np.float32))
    return w0, b0, w1, b1


def from_fragments(p: torch.Tensor) -> torch.Tensor:
    """The inverse of `stem.to_fragments`: [S, N/16 * 256] -> [S, 16, N]."""
    p = p.reshape(p.shape[0], -1, 32, 8)
    k, col = stem._fragment_index(16 * p.shape[1])
    b = p.new_zeros(p.shape[0], 16, 16 * p.shape[1])
    b[:, k, col] = p
    return b


def _epilogue(acc: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    return F.silu(acc.to(dtype) + b.to(dtype))


def stem_gemm(images, w0p, b0, w1p, b1, dtype) -> torch.Tensor:
    """The tensor-core kernel's GEMMs over the packed weights, [B, H/4, W/4, c1]."""
    B0 = from_fragments(w0p).float()  # [3, 16, c0]
    B1 = from_fragments(w1p).float()  # [9 c0/16, 16, c1]
    c0, c1 = B0.shape[2], B1.shape[2]
    x = images.to(dtype).float()
    b, h, w, _ = x.shape
    h0, w0 = h // 2, w // 2
    # Input padded by one pixel on top and left (conv0's padding), more at
    # the bottom and right so the pair reads of the last pixel stay inside.
    xp = F.pad(x, (0, 0, 1, 3, 1, 3))
    zero = xp.new_zeros(b, h0, w0, 2)
    acc = 0.0
    for kh in range(3):
        rows = xp[:, kh:kh + 2 * h0:2]  # input row 2i - 1 + kh
        px = [rows[:, :, d:d + 2 * w0:2] for d in range(4)]  # pixels 2j - 1 + d
        a = torch.cat([px[0], px[1], zero, px[2], px[3], zero], dim=-1)  # the k16 step's 16 values
        acc = acc + a @ B0[kh]
    y0 = _epilogue(acc, b0, dtype).float()
    y0 = F.pad(y0, (0, 0, 1, 1, 1, 1))  # conv1's zero padding
    h1, w1 = h // 4, w // 4
    acc = 0.0
    for tap in range(9):
        kh, kw = divmod(tap, 3)
        a = y0[:, kh:kh + 2 * h1:2, kw:kw + 2 * w1:2]
        for cb in range(c0 // 16):
            acc = acc + a[..., 16 * cb:16 * cb + 16] @ B1[tap * (c0 // 16) + cb]
    return _epilogue(acc, b1, dtype)


def test_every_size_has_a_stem_width():
    """Every YOLOv10 size's backbone cv0/cv1 widths are ones the stem takes,
    in the wrapper and in the CUDA sources' list of compiled instances."""
    import re

    from leanyolo_tpu_torch.models.yolov10.config import VARIANTS

    with open(KERNELS_H) as fh:
        line = next(ln for ln in fh if ln.startswith("#define STEM_WIDTHS(X)"))
    compiled = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", line)}
    sizes = {(cfg.ch[0], cfg.ch[1]) for cfg in VARIANTS.values()}
    assert len(VARIANTS) == 6 and sizes == set(stem.WIDTHS) == compiled
    for name, cfg in VARIANTS.items():
        model = YOLOv10.create(name, class_names=["a"], seed=0)
        w0, w1 = model.backbone.cv0.conv.weight, model.backbone.cv1.conv.weight
        assert (w0.shape[0], w1.shape[0]) == (cfg.ch[0], cfg.ch[1]) in stem.WIDTHS


def test_stem_bounds():
    """The bound chip_smoke.py prints beside the stem of each size: the
    images, the weights and the bf16 output moved once (yolov10s: 0.0431 ms
    at 3.35 TB/s); the wider sizes are bound by their products."""
    from leanyolo_tpu_torch.kernels import bounds

    nbytes, nops = bounds.stem_work(32, 640, 640, 32, 64)
    assert nbytes == 32 * 640 * 640 * 3 + 32 * 160 * 160 * 64 * 2 + 2 * (27 * 32 + 32 + 9 * 32 * 64 + 64)
    ms, by = bounds.bound(nbytes, nops)
    assert by == "bytes" and abs(ms - 0.04305) < 1e-5
    rows = {r[0]: r for r in bounds.kernel_bounds()}
    assert rows["stem yolov10x"][-1] == "operations" and rows["stem yolov10b"][-2] == rows["stem yolov10l"][-2]


@pytest.mark.parametrize("c0,c1", WIDTHS)
def test_pack_weights_round_trip(c0, c1):
    w0, _, w1, _ = _weights(np.random.RandomState(0), c0, c1)
    w0p, w1p = stem.pack_weights(w0, w1)
    assert tuple(w0p.shape) == (3, c0 * 16) and tuple(w1p.shape) == (9 * c0 // 16, c1 * 16)
    b0m, b1m = from_fragments(w0p), from_fragments(w1p)
    assert torch.equal(b0m, stem.conv0_matrix(w0)) and torch.equal(b1m, stem.conv1_matrix(w1))
    # conv0: every weight once, at its (kernel row, k) slot; the padded k rows are zero.
    for k, kc in enumerate(stem.CONV0_K):
        if kc is None:
            assert not b0m[:, k].any()
        else:
            kw, ci = kc
            assert torch.equal(b0m[:, k], w0[:, ci, :, kw].t())
    # conv1: tap-major, input channel within.
    back = b1m.reshape(3, 3, c0, c1).permute(3, 2, 0, 1)
    assert torch.equal(back, w1)


@pytest.mark.parametrize("c0,c1", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [(2, 64, 96), (1, 128, 64)])
def test_packed_gemms_match_plain_stem(c0, c1, dtype, size):
    rng = np.random.RandomState(1)
    b, h, w = size
    img = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8))
    w0, b0, w1, b1 = (t.to(dtype) for t in _weights(rng, c0, c1))
    ref = stem.fused_stem_plain(img, w0, b0, w1, b1, dtype=dtype)
    w0p, w1p = stem.pack_weights(w0, w1)
    got = stem_gemm(img, w0p, b0, w1p, b1, dtype)
    assert got.shape == (b, h // 4, w // 4, c1) and got.dtype == dtype
    tol = 5e-4 * max(1.0, float(ref.abs().max())) if dtype == torch.float32 else bf16_ulps(as_f32(ref), 4)
    assert float((got.float() - ref.float()).abs().max()) <= tol


def test_packed_gemms_match_pallas_fused_stem():
    from stem_pallas import fused_stem, prepare_stem_params

    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    w0 = (rng.randn(3, 3, 3, 32) * 0.5).astype(np.float32)  # HWIO, before the /255 fold
    b0 = (rng.randn(32) * 0.1).astype(np.float32)
    w1 = (rng.randn(3, 3, 32, 64) * 0.1).astype(np.float32)
    b1 = (rng.randn(64) * 0.1).astype(np.float32)
    div = np.full(3, 255.0, np.float32)
    sp = prepare_stem_params(w0, b0, w1, b1, input_subtract=np.zeros(3, np.float32), input_divide=div)
    ref = as_f32(fused_stem(jnp.asarray(img), sp, t1=8, w1t=16, interpret=True))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16()  # noqa: E731
    w0t = t((w0 / div[None, None, :, None]).transpose(3, 2, 0, 1))
    w1t = t(w1.transpose(3, 2, 0, 1))
    w0p, w1p = stem.pack_weights(w0t, w1t)
    got = stem_gemm(torch.from_numpy(img), w0p, t(b0), w1p, t(b1), torch.bfloat16)
    assert got.shape == (2, 16, 16, 64)
    assert np.max(np.abs(as_f32(got) - ref)) <= bf16_ulps(ref, 4)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_fold_packs_the_stem_weights_once(dtype):
    model = YOLOv10.create("yolov10n", class_names=["a", "b"], seed=0)
    assert model.backbone.stem_w0p is None  # unfolded: nothing packed
    folded = fold_model(model, dtype=dtype)
    bb = folded.backbone
    w0p, w1p = stem.pack_weights(bb.cv0.conv.weight, bb.cv1.conv.weight)
    assert torch.equal(bb.stem_w0p, w0p) and torch.equal(bb.stem_w1p, w1p)
    assert bb.stem_w0p.dtype == (dtype or torch.float32)
    sd = folded.state_dict()
    assert not any("stem_w" in k for k in sd)  # packed weights stay out of the state dict
    # A state-dict load packs again.
    sd = {k: (torch.randn_like(v) if v.is_floating_point() else v) for k, v in sd.items()}
    folded.load_state_dict(sd)
    w0p, w1p = stem.pack_weights(sd["backbone.cv0.conv.weight"], sd["backbone.cv1.conv.weight"])
    assert torch.equal(bb.stem_w0p, w0p) and torch.equal(bb.stem_w1p, w1p)


def test_folded_forward_hands_the_packed_weights_to_the_stem(monkeypatch):
    folded = fold_model(YOLOv10.create("yolov10n", class_names=["a", "b"], seed=1)).eval()
    seen = []
    wrapper = stem.fused_stem
    monkeypatch.setattr(stem, "fused_stem", lambda *a, **k: seen.append(k.get("packed")) or wrapper(*a, **k))
    n = dict(kernels.LAUNCHES)
    with torch.no_grad():
        folded(torch.zeros(1, 64, 64, 3, dtype=torch.uint8), branches=("one2one",), normalize=False)
    assert len(seen) == 1 and seen[0][0] is folded.backbone.stem_w0p and seen[0][1] is folded.backbone.stem_w1p
    assert kernels.LAUNCHES == n  # the CPU takes the plain version
