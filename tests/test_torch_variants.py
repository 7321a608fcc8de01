"""yolov10m and yolov10x, at their published widths and depths, in the port
against the JAX package on the same parameters and the same images.

Between them, m and x take every block choice of b and l: C2fCIB with and
without the residual, plain C2f, the large-kernel switches off, widths not
a power of two (48 ... 576 for m, 80 ... 640 for x) and the stem widths
(48, 96) and (80, 160). 64 px keeps the CPU time low; one JAX and one port
model per module fixture.

fp32: every one2one head map, unfolded and folded, agrees to < 5e-4 of its
scale. `Predictor(device="cpu", fuse=True)` against the JAX predictor: the
count above the confidence threshold matches, and class, score and box
match at every rank the scores decide by more than 1e-4; JAX's
`decode_topk` on the port's own head maps selects the port's detections
rank for rank (classes bit-exact; scores and boxes, fp32 math on the same
logits, within 1e-6 and 1e-5 of the image size).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.engine.predictor import Predictor as JPredictor
from leanyolo_tpu.models.yolov10.decode import decode_topk as jax_decode_topk
from leanyolo_tpu.models.yolov10.fold import fold_params
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10, model_apply
from leanyolo_tpu_torch import Predictor, YOLOv10
from leanyolo_tpu_torch.models.yolov10.convert import load_jax_params
from leanyolo_tpu_torch.models.yolov10.fold import fold_model
from torch_parity import as_f32, randomize_bn

NC, SIZE = 80, 64


def _setup(name: str, seed: int):
    jm = JYOLOv10.create(name, class_names=[f"c{i}" for i in range(NC)], seed=seed)
    jm = JYOLOv10(cfg=jm.cfg, class_names=jm.class_names, params=randomize_bn(jm.params, np.random.RandomState(seed)))
    tm = load_jax_params(YOLOv10.create(name, class_names=jm.class_names), jm.params).eval()
    return jm, tm


@pytest.fixture(scope="module")
def m_models():
    return _setup("yolov10m", 11)


@pytest.fixture(scope="module")
def x_models():
    return _setup("yolov10x", 12)


def _models(request, which):
    return request.getfixturevalue(f"{which}_models")


def _images(seed: int, b: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8)


def _assert_maps_close(ref, got):
    for r_lvl, g_lvl in zip(ref, got):
        for r, g in zip(r_lvl, g_lvl):
            r, g = as_f32(r), as_f32(g)
            assert g.shape == r.shape
            err = np.max(np.abs(g - r))
            assert err < 5e-4 * max(1.0, np.max(np.abs(r))), (err, np.max(np.abs(r)))


@pytest.mark.parametrize("which", ["m", "x"])
@pytest.mark.parametrize("folded", [False, True])
def test_variant_head_maps_match_jax(request, which, folded):
    jm, tm = _models(request, which)
    imgs = _images(1)
    kw = dict(branches=("one2one",), normalize=not folded, concat_head=False)
    params = fold_params(jm.params) if folded else jm.params
    fn = jax.jit(lambda p, x: model_apply(p, x.astype(jnp.float32), jm.cfg, train=False, **kw)["one2one"])
    ref = fn(params, jnp.asarray(imgs))
    model = fold_model(tm) if folded else tm
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), dtype=torch.float32, **kw)["one2one"]
    _assert_maps_close(ref, got)


@pytest.mark.parametrize("which", ["m", "x"])
def test_variant_predictor_dets_match_jax(request, which):
    jm, tm = _models(request, which)
    imgs = _images(2)
    jd, jn = JPredictor(jm, imgsz=SIZE, decode="topk", fuse=True, donate=False).run_batch(jnp.asarray(imgs))
    jd, jn = np.asarray(jd), np.asarray(jn)
    pred = Predictor(tm, imgsz=SIZE, decode="topk", fuse=True, device="cpu")
    td, tn = (t.numpy() for t in pred.run_batch(imgs))
    assert td.shape == jd.shape and tn.dtype == np.int32
    np.testing.assert_array_equal(tn, jn)
    s = jd[..., 4]
    gap = np.minimum(np.abs(np.diff(s, axis=1, prepend=np.inf)), np.abs(np.diff(s, axis=1, append=-np.inf)))
    decided = gap > 1e-4
    assert decided.sum() >= 10, decided.sum()
    np.testing.assert_array_equal(td[..., 5][decided], jd[..., 5][decided])
    np.testing.assert_allclose(td[..., 4][decided], s[decided], rtol=0, atol=5e-4)
    np.testing.assert_allclose(td[..., :4][decided], jd[..., :4][decided], rtol=0, atol=5e-4 * SIZE)
    # The port's own head maps through both decodes: the same selection,
    # rank for rank (class bit-exact, and each rank's anchor: its box within
    # fp32 rounding of the DFL math).
    maps = pred.raw(imgs)
    ref = np.asarray(jax_decode_topk([tuple(jnp.asarray(as_f32(t)) for t in lvl) for lvl in maps], num_classes=NC,
                                     strides=jm.cfg.strides, max_det=300))
    np.testing.assert_array_equal(td[..., 5], ref[..., 5])
    np.testing.assert_allclose(td[..., 4], ref[..., 4], rtol=0, atol=1e-6)
    np.testing.assert_allclose(td[..., :4], ref[..., :4], rtol=0, atol=1e-5 * SIZE)
