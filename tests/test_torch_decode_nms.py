"""The port's NMS decode (leanyolo_tpu_torch/models/yolov10/decode.py:
decode_nms, decode_direct_nms, the box decode of every anchor, the host
tail) against the JAX package on the same head maps, on the CPU.

The selection is bit-exact: `num`, the classes and the order of the kept
rows. Scores are the sigmoid of the same logits, which torch and JAX round
one fp32 ulp apart on 0.38% of inputs: within 2.4e-7. Boxes are fp32 DFL
math on the same anchors: within 1e-4 of the image size.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10 import decode as JD
from leanyolo_tpu_torch.models.yolov10 import decode as TD

NC, REG = 80, 16
STRIDES = (8, 16, 32)
SIZE = 128


def _maps(seed: int, b: int = 2, size: int = SIZE):
    """Per-level (reg, cls) NHWC fp32 maps; a few anchors score high, coarse
    cls values force ties."""
    rng = np.random.RandomState(seed)
    out = []
    for s in STRIDES:
        h = size // s
        reg = (rng.randn(b, h, h, 4 * REG) * 2).astype(np.float32)
        cls = (np.round((rng.randn(b, h, h, NC) * 3 - 5) * 4) / 4).astype(np.float32)
        out.append((reg, cls))
    return out


def _pair(maps, dtype):
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    return ([(jnp.asarray(r, jd), jnp.asarray(c, jd)) for r, c in maps],
            [(torch.from_numpy(r).to(td), torch.from_numpy(c).to(td)) for r, c in maps])


def _assert_same(got, ref, size=SIZE):
    (gd, gn), (rd, rn) = got, ref
    gd, gn, rd, rn = gd.numpy(), gn.numpy(), np.asarray(rd, np.float32), np.asarray(rn)
    assert gd.shape == rd.shape and gd.dtype == np.float32 and gn.dtype == np.int32
    np.testing.assert_array_equal(gn, rn)
    np.testing.assert_array_equal(gd[..., 5], rd[..., 5])  # classes, in rank order; zero rows past num
    np.testing.assert_allclose(gd[..., 4], rd[..., 4], rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(gd[..., :4], rd[..., :4], rtol=0, atol=1e-4 * size)
    for i, n in enumerate(gn):
        assert not gd[i, n:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("multi_label", [False, True])
@pytest.mark.parametrize("class_wise", [False, True])
@pytest.mark.parametrize("pre_topk,max_det", [(1000, 300), (1000, 9), (7, 300)])
def test_decode_nms_matches_jax(dtype, multi_label, class_wise, pre_topk, max_det):
    maps = _maps(3)
    jmaps, tmaps = _pair(maps, dtype)
    kw = dict(num_classes=NC, strides=STRIDES, conf_thresh=0.05, iou_thresh=0.45, max_det=max_det,
              pre_topk=pre_topk, class_wise=class_wise, multi_label=multi_label)
    ref = JD.decode_nms(jmaps, **kw)
    got = TD.decode_nms(tmaps, **kw)
    _assert_same(got, ref)
    n = got[1].numpy()
    assert n.min() > (0 if pre_topk > max_det else 1) and (max_det > 9 or n.max() == max_det)


@pytest.mark.parametrize("multi_label", [False, True])
def test_decode_nms_fp32_ranking_equals_the_upcast(multi_label):
    """bf16 maps ranked as fp32 give JAX's decode of the fp32 upcast maps,
    the predictor's NMS path, bit for bit (the validator's thresholds)."""
    maps = _maps(4)
    jmaps, tmaps = _pair(maps, "bfloat16")
    kw = dict(num_classes=NC, strides=STRIDES, conf_thresh=0.001, iou_thresh=0.65, max_det=300,
              multi_label=multi_label)
    ref = JD.decode_nms([tuple(t.astype(jnp.float32) for t in lv) for lv in jmaps], **kw)
    got = TD.decode_nms(tmaps, rank_dtype=torch.float32, **kw)
    _assert_same(got, ref)


def test_decode_nms_concat_maps_equal_split_maps():
    maps = _maps(5)
    split = [(torch.from_numpy(r), torch.from_numpy(c)) for r, c in maps]
    concat = [torch.cat(p, dim=-1) for p in split]
    a = TD.decode_nms(split, num_classes=NC, conf_thresh=0.05)
    b = TD.decode_nms(concat, num_classes=NC, conf_thresh=0.05)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_decode_direct_nms_matches_jax():
    rng = np.random.RandomState(6)
    maps = [np.concatenate([rng.randn(2, SIZE // s, SIZE // s, 4) * 0.5,
                            np.round((rng.randn(2, SIZE // s, SIZE // s, NC) * 3 - 4) * 4) / 4], -1).astype(np.float32)
            for s in STRIDES]
    kw = dict(num_classes=NC, strides=STRIDES, conf_thresh=0.05, iou_thresh=0.45, max_det=100)
    ref = JD.decode_direct_nms([jnp.asarray(m) for m in maps], **kw)
    got = TD.decode_direct_nms([torch.from_numpy(m) for m in maps], **kw)
    _assert_same(got, ref)
    assert got[1].min() > 5


def test_flatten_pyramid_matches_jax():
    """JAX's dense decode `_flatten_pyramid` (its serving export's boxes and
    class logits) against what the port's export takes instead: the box
    decode kernel's plain version over every anchor, read in place from the
    concatenated maps' reg slices, and the levels' class slices."""
    from leanyolo_tpu_torch.kernels import dfl

    maps = _maps(7)
    concat = [np.concatenate(p, -1) for p in maps]
    rb, rc = JD._flatten_pyramid([jnp.asarray(m) for m in concat], NC, STRIDES)
    levels, hw, reg_max = TD._split_levels([torch.from_numpy(m) for m in concat], NC)
    assert reg_max == REG
    a = sum(h * w for h, w in hw)
    idx = torch.arange(a, dtype=torch.int32).repeat(2, 1)
    gb = dfl.dfl_boxes([r for r, _ in levels], hw, STRIDES, idx)
    gc = torch.cat([c for _, c in levels], dim=1)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=0, atol=1e-4 * SIZE)


@pytest.mark.parametrize("decode,apply", [("topk", True), ("topk", False), ("nms", True)])
def test_postprocess_to_original_matches_jax(decode, apply):
    rng = np.random.RandomState(8)
    dets = np.concatenate([rng.uniform(-10, 700, (3, 20, 4)), np.sort(rng.uniform(0, 1, (3, 20, 1)), axis=1)[:, ::-1],
                           rng.randint(0, NC, (3, 20, 1))], -1).astype(np.float32)
    num = np.array([0, 7, 20], np.int32)
    metas = [((0.5, 0.5), (0, 80), (960, 1280)), ((1.25, 1.25), (12, 0), (512, 400)), ((1.0, 1.0), (0, 0), (640, 640))]
    ref = JD.postprocess_to_original(dets, num, metas, decode=decode, conf_thresh=0.4, apply_conf_filter=apply)
    got = TD.postprocess_to_original(torch.from_numpy(dets), torch.from_numpy(num), metas, decode=decode,
                                     conf_thresh=0.4, apply_conf_filter=apply)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    lists = TD.detections_to_list(torch.from_numpy(dets), torch.from_numpy(num), conf_thresh=0.4)
    for g, r in zip(lists, JD.detections_to_list(dets, num, conf_thresh=0.4)):
        np.testing.assert_array_equal(g, r)


def _direct_maps(seed: int, size: int = SIZE):
    rng = np.random.RandomState(seed)
    return [np.concatenate([rng.randn(2, size // s, size // s, 4) * 0.5,
                            np.round((rng.randn(2, size // s, size // s, NC) * 3 - 4) * 4) / 4], -1).astype(np.float32)
            for s in STRIDES]


@pytest.mark.parametrize("seed,iou", [(6, 0.45), (7, 0.451), (8, 0.65)])
def test_decode_direct_nms_bf16_bit_equal_to_jax(seed, iou):
    """bf16 maps: the box arithmetic, sigmoid, max, argmax, top-k and classes
    in bf16 and the NMS in bf16 arithmetic, as JAX's; dets and num bit-equal."""
    maps = _direct_maps(seed)
    kw = dict(num_classes=NC, strides=STRIDES, conf_thresh=0.05, iou_thresh=iou, max_det=100)
    rd, rn = JD.decode_direct_nms([jnp.asarray(m, jnp.bfloat16) for m in maps], **kw)
    gd, gn = TD.decode_direct_nms([torch.from_numpy(m).to(torch.bfloat16) for m in maps], **kw)
    assert gd.dtype == torch.float32 and gn.dtype == torch.int32
    np.testing.assert_array_equal(gn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(gd.numpy().view(np.int32), np.asarray(rd, np.float32).view(np.int32))
    assert gn.min() > 5


def test_decode_direct_nms_rejects_mixed_dtypes():
    maps = [torch.from_numpy(m) for m in _direct_maps(6)]
    with pytest.raises(ValueError, match="one dtype"):
        TD.decode_direct_nms([maps[0].bfloat16(), *maps[1:]], num_classes=NC, strides=STRIDES)


def test_bf16_sigmoid_bit_equal_to_jax_on_every_bf16():
    """XLA expands a bf16 sigmoid as 1 / (1 + exp(-x)), each step rounded to
    bf16, subnormals flushed; torch.sigmoid rounds once and differs on 1116
    of the finite bf16 inputs. The port's bf16 sigmoid equals JAX's on all."""
    import jax

    x = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = x[torch.isfinite(x)]
    ref = np.asarray(jax.nn.sigmoid(jnp.asarray(x.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_array_equal(TD._sigmoid(x).float().numpy(), ref)
    assert (torch.sigmoid(x).float().numpy() != ref).sum() > 1000
