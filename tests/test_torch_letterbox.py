"""The port's letterbox (leanyolo_tpu_torch/ops/letterbox.py) and box
inverse (ops/boxes.py) against the JAX package on the CPU.

The host letterbox reproduces cv2's uint8 INTER_LINEAR in its fixed point
with no cv2: the JAX `letterbox` (which calls cv2) and the port give equal
pixels, bit for bit, at every shape below (up- and down-scales, odd sizes,
both aspect ratios, auto, scale_fill, scaleup=False). The device warp
`letterbox_batch` is fp32 arithmetic on both sides: within 1e-4 on the
0-255 scale.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.ops import boxes as JB
from leanyolo_tpu.ops import letterbox as JL
from leanyolo_tpu_torch.ops import boxes as TB
from leanyolo_tpu_torch.ops import letterbox as TL


def _img(seed: int, h: int, w: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("h,w,target", [(480, 640, 640), (640, 480, 640), (1080, 1920, 640), (100, 133, 640),
                                        (37, 51, 96), (333, 517, 640), (640, 1280, 320), (7, 5, 64),
                                        (9, 300, 64), (250, 250, 64)])
def test_letterbox_bit_equal_to_cv2(h, w, target):
    img = _img(h * 7 + w, h, w)
    ref, rgain, rpad = JL.letterbox(img, target)
    got, ggain, gpad = TL.letterbox(img, target)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (target, target, 3)
    assert ggain == rgain and gpad == rpad
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw", [dict(auto=True), dict(scale_fill=True), dict(scaleup=False),
                                dict(new_shape=(320, 480)), dict(new_shape=(320, 480), auto=True, stride=64),
                                dict(color=(0, 50, 255))])
@pytest.mark.parametrize("h,w", [(77, 129), (700, 450)])
def test_letterbox_options_bit_equal_to_cv2(kw, h, w):
    img = _img(h + w, h, w)
    kw = dict(kw)
    shape = kw.pop("new_shape", 256)
    ref, rgain, rpad = JL.letterbox(img, shape, **kw)
    got, ggain, gpad = TL.letterbox(img, shape, **kw)
    assert got.shape == ref.shape and ggain == rgain and gpad == rpad
    np.testing.assert_array_equal(got, ref)


def test_resize_of_other_dtypes_keeps_the_geometry():
    """A float image takes cv2's geometry in fp32 arithmetic (no fixed point)."""
    img = _img(3, 45, 70).astype(np.float32)
    got = TL.resize_linear(img, 97, 61)
    ref = TL.resize_linear(img.astype(np.uint8), 97, 61).astype(np.float32)
    assert got.dtype == np.float32 and got.shape == (61, 97, 3)
    assert np.abs(got - ref).max() <= 1.0


def test_geometry_helpers_match_jax():
    for hw in ((480, 640), (1, 1), (2000, 30), (1280, 1281)):
        assert TL.choose_bucket(hw) == JL.choose_bucket(hw)
        for target in (64, 640):
            for up in (True, False):
                assert TL.letterbox_params(hw, target, up) == JL.letterbox_params(hw, target, up)
    meta = [{"height": 480, "width": 640}, {"height": 1400, "width": 900}]
    assert TL.dataset_canvas_size(meta, 640) == JL.dataset_canvas_size(meta, 640)
    with pytest.raises(ValueError, match="lack height/width"):
        TL.dataset_canvas_size([{"id": 3}], 640)


def test_canvas_batch_and_device_warp_match_jax():
    imgs = [_img(1, 48, 80), _img(2, 80, 48), _img(3, 131, 67), _img(4, 300, 211)]
    ref = JL.canvas_batch(imgs, 64)
    got = TL.canvas_batch(imgs, 64)
    for r, g in zip(ref[:4], got[:4]):
        np.testing.assert_array_equal(g, r)
    assert got[4] == ref[4]
    canvas, new_hw, pads, hw, _ = got
    want = np.asarray(JL.letterbox_batch_jax(jnp.asarray(canvas), jnp.asarray(new_hw), jnp.asarray(pads),
                                             jnp.asarray(hw), 64))
    out = TL.letterbox_batch(torch.from_numpy(canvas), torch.from_numpy(new_hw), torch.from_numpy(pads),
                             torch.from_numpy(hw), 64)
    assert out.dtype == torch.float32 and out.shape == (4, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-4)
    # The warp against the host letterbox: within 2 levels, as the JAX package holds its warp.
    for i, img in enumerate(imgs):
        assert np.abs(out[i].numpy() - TL.letterbox(img, 64)[0].astype(np.float32)).max() <= 2.0


def test_letterbox_image_matches_jax():
    """The single-image device letterbox: a linear resize (antialiased on a
    shrink, as jax.image.resize) and the pad."""
    for h, w in ((48, 80), (300, 211)):
        img = _img(h, h, w)
        ref, rgain, rpad = JL.letterbox_jax(img, 64)
        got, ggain, gpad = TL.letterbox_image(img, 64)
        assert (ggain, gpad) == (rgain, rpad) and got.shape == (64, 64, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_scale_and_unletterbox_coords_match_jax():
    rng = np.random.RandomState(9)
    boxes = rng.uniform(-20, 700, (2, 30, 4)).astype(np.float32)
    np.testing.assert_array_equal(TB.scale_coords((640, 640), torch.from_numpy(boxes), (480, 853)).numpy(),
                                  np.asarray(JB.scale_coords((640, 640), jnp.asarray(boxes), (480, 853))))
    for gain, pad, to in (((0.5, 0.5), (0, 80), (960, 1280)), ((1.3, 1.3), (17, 0), (300, 492))):
        np.testing.assert_array_equal(TB.unletterbox_coords(torch.from_numpy(boxes), gain, pad, to).numpy(),
                                      np.asarray(JB.unletterbox_coords(jnp.asarray(boxes), gain, pad, to)))
