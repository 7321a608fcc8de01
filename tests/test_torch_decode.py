"""The port's decode (leanyolo_tpu_torch/models/yolov10/decode.py) and anchor
math against the JAX package, on the same head maps.

The selection (which anchor, which class, in which order) must be bit-exact:
both sides rank the same values with the same tie rule. Boxes and scores
are fp32 math on the selected anchors and agree to < 5e-4 (boxes relative
to their pixel scale).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10.decode import decode_topk as jax_decode_topk
from leanyolo_tpu.ops import anchors as JA
from leanyolo_tpu_torch.models.yolov10.decode import decode_topk
from leanyolo_tpu_torch.ops import anchors as TA

NC, REG = 80, 16
STRIDES = (8, 16, 32)


def _maps(seed: int, b: int, size: int, ties: bool):
    """Per-level (reg, cls) NHWC maps as numpy fp32; coarse cls values force ties."""
    rng = np.random.RandomState(seed)
    out = []
    for s in STRIDES:
        h = size // s
        reg = rng.randn(b, h, h, 4 * REG).astype(np.float32) * 2
        cls = rng.randn(b, h, h, NC).astype(np.float32) * 3 - 4
        if ties:
            cls = np.round(cls * 2) / 2
        out.append((reg, cls))
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("size,ties", [(640, True), (640, False), (128, True)])
def test_decode_topk_matches_jax(dtype, size, ties):
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    maps = _maps(size + ties, 2, size, ties)
    jmaps = [(jnp.asarray(r, jd), jnp.asarray(c, jd)) for r, c in maps]
    tmaps = [(torch.from_numpy(r).to(td), torch.from_numpy(c).to(td)) for r, c in maps]
    ref = np.asarray(jax_decode_topk(jmaps, num_classes=NC, strides=STRIDES, max_det=300), np.float32)
    got = decode_topk(tmaps, num_classes=NC, strides=STRIDES, max_det=300).numpy()
    k = min(300, sum((size // s) ** 2 for s in STRIDES))
    assert got.shape == ref.shape == (2, k, 6)
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])  # classes, in rank order
    np.testing.assert_allclose(got[..., 4], ref[..., 4], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=5e-4 / size, atol=5e-4)
    # Same anchors: the box of each rank matches far tighter than a cell apart.
    assert np.max(np.abs(got[..., :4] - ref[..., :4])) < 1e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_topk_max_det_past_1024_matches_jax(dtype):
    """max_det = 1500 at 320 px (2100 anchors): both top-k stages take k past
    the old cap of 1024, the second over 1500 x 80 pairs (64-bit keys)."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    maps = _maps(320, 2, 320, True)
    jmaps = [(jnp.asarray(r, jd), jnp.asarray(c, jd)) for r, c in maps]
    tmaps = [(torch.from_numpy(r).to(td), torch.from_numpy(c).to(td)) for r, c in maps]
    ref = np.asarray(jax_decode_topk(jmaps, num_classes=NC, strides=STRIDES, max_det=1500), np.float32)
    got = decode_topk(tmaps, num_classes=NC, strides=STRIDES, max_det=1500).numpy()
    assert got.shape == ref.shape == (2, 1500, 6)
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])  # classes, in rank order
    np.testing.assert_array_equal(got[..., 4], ref[..., 4])  # scores: the sigmoid of the same logits
    np.testing.assert_allclose(got[..., :4], ref[..., :4], rtol=5e-4 / 320, atol=5e-4)
    assert np.max(np.abs(got[..., :4] - ref[..., :4])) < 1e-2


def test_decode_topk_concat_maps_equal_split_maps():
    maps = _maps(7, 2, 128, True)
    split = [(torch.from_numpy(r), torch.from_numpy(c)) for r, c in maps]
    concat = [torch.cat(p, dim=-1) for p in split]
    a = decode_topk(split, num_classes=NC, strides=STRIDES)
    b = decode_topk(concat, num_classes=NC, strides=STRIDES)
    assert torch.equal(a, b)


def test_anchor_math_matches_jax():
    rng = np.random.RandomState(0)
    shapes = [(8, 10), (4, 5), (2, 3)]
    ja, js = JA.make_anchors(shapes, STRIDES)
    ta, ts = TA.make_anchors(shapes, STRIDES)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    logits = rng.randn(3, 7, 4 * REG).astype(np.float32) * 3
    jd = np.asarray(JA.dfl_expectation(jnp.asarray(logits), REG))
    td = TA.dfl_expectation(torch.from_numpy(logits), REG).numpy()
    np.testing.assert_allclose(td, jd, rtol=0, atol=5e-5)
    dist = np.abs(rng.randn(3, 7, 4)).astype(np.float32)
    pts = rng.rand(7, 2).astype(np.float32) * 10
    r = np.asarray(JA.dist2bbox(jnp.asarray(dist), jnp.asarray(pts), xywh=False))
    g = TA.dist2bbox(torch.from_numpy(dist), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
