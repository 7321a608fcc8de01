"""The whole slice: JAX `Predictor(fuse=True)` against the port's
`Predictor(device="cpu")` on the same parameters and the same uint8 images.

fp32: the one2one head maps agree to < 5e-4 of their scale, and the
detections agree wherever the ranking is decided by more than that: at every
rank whose score is apart from its neighbours' by more than 1e-4, class and
score match and the box matches to < 5e-4 of the image size. bf16: head maps
to 4 bf16 ulps of max(1, map scale), as in test_torch_model.py.

The NMS decode (one2many branch), where the ranking is decided at these
sizes: `num` and the classes exact; fp32 scores and boxes as above; bf16
scores within 4 bf16 ulps (2^-8 each) and boxes within 4 bf16 ulps of the
image size. `predict_images` in both preprocess modes and both decodes, on
images of mixed sizes, against JAX's, in fp32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.engine.predictor import Predictor as JPredictor
from leanyolo_tpu.models.yolov10.fold import fold_params
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10, model_apply
from leanyolo_tpu_torch import Predictor, YOLOv10
from leanyolo_tpu_torch.models.yolov10.convert import load_jax_params
from torch_parity import as_f32, bf16_ulps, randomize_bn


def _setup(name: str, nc: int, seed: int):
    jm = JYOLOv10.create(name, class_names=[f"c{i}" for i in range(nc)], seed=seed)
    jm = JYOLOv10(cfg=jm.cfg, class_names=jm.class_names, params=randomize_bn(jm.params, np.random.RandomState(seed)))
    tm = load_jax_params(YOLOv10.create(name, class_names=jm.class_names), jm.params)
    return jm, tm


@pytest.fixture(scope="module")
def s_models():
    return _setup("yolov10s", 80, 5)


def _images(seed, b=2, s=64):
    return np.random.RandomState(seed).randint(0, 256, (b, s, s, 3)).astype(np.uint8)


def _jax_raw(jm, imgs, dtype):
    params = fold_params(jm.params, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fn = jax.jit(lambda p, x: model_apply(p, x.astype(jd), jm.cfg, train=False, branches=("one2one",),
                                          normalize=False, concat_head=False)["one2one"])
    return [tuple(as_f32(t) for t in lvl) for lvl in fn(params, jnp.asarray(imgs))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_head_maps_match(s_models, dtype):
    jm, tm = s_models
    imgs = _images(0)
    ref = _jax_raw(jm, imgs, dtype)
    got = Predictor(tm, imgsz=64, dtype=dtype, fuse=True, device="cpu").raw(imgs)
    for r_lvl, g_lvl in zip(ref, got):
        for r, g in zip(r_lvl, g_lvl):
            g = as_f32(g)
            assert g.shape == r.shape
            err = np.max(np.abs(g - r))
            tol = 5e-4 * max(1.0, np.max(np.abs(r))) if dtype == "float32" else bf16_ulps(r, 4)
            assert err <= tol, (err, np.max(np.abs(r)))


@pytest.mark.parametrize("name,size", [("yolov10s", 64), ("yolov10n", 96)])
def test_predictor_dets_match_fp32(s_models, name, size):
    jm, tm = s_models if name == "yolov10s" else _setup(name, 8, 6)
    imgs = _images(1, s=size)
    jd, jn = JPredictor(jm, imgsz=size, decode="topk", fuse=True, donate=False).run_batch(jnp.asarray(imgs))
    jd, jn = np.asarray(jd), np.asarray(jn)
    td, tn = Predictor(tm, imgsz=size, decode="topk", fuse=True, device="cpu").run_batch(imgs)
    td, tn = td.numpy(), tn.numpy()
    assert td.shape == jd.shape and td.dtype == np.float32 and tn.dtype == np.int32
    np.testing.assert_array_equal(tn, jn)
    s = jd[..., 4]
    gap = np.minimum(np.abs(np.diff(s, axis=1, prepend=np.inf)), np.abs(np.diff(s, axis=1, append=-np.inf)))
    decided = gap > 1e-4
    assert decided.sum() >= 10, decided.sum()
    np.testing.assert_array_equal(td[..., 5][decided], jd[..., 5][decided])
    np.testing.assert_allclose(td[..., 4][decided], s[decided], rtol=0, atol=5e-4)
    np.testing.assert_allclose(td[..., :4][decided], jd[..., :4][decided], rtol=0, atol=5e-4 * size)


def test_predictor_without_device_raises_when_no_card(s_models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(s_models[1], imgsz=64)


def test_predictor_rejects_unported_options(s_models):
    """Every decode of the JAX predictor is ported now ('topk', 'nms'); an
    unknown decode, dtype, size or preprocess mode raises."""
    with pytest.raises(ValueError, match="unknown decode"):
        Predictor(s_models[1], imgsz=64, decode="nms_approx", device="cpu")
    with pytest.raises(ValueError):
        Predictor(s_models[1], imgsz=60, device="cpu")
    with pytest.raises(ValueError, match="unknown dtype"):
        Predictor(s_models[1], imgsz=64, dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="unknown preprocess"):
        Predictor(s_models[1], imgsz=64, device="cpu").predict_images([_images(0)[0]], preprocess="gpu")


def _assert_nms_dets(td, tn, jd, jn, size, dtype):
    jd, jn = np.asarray(jd), np.asarray(jn)
    assert td.shape == jd.shape and td.dtype == np.float32 and tn.dtype == np.int32
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(td[..., 5], jd[..., 5])
    if dtype == "float32":
        np.testing.assert_allclose(td[..., 4], jd[..., 4], rtol=0, atol=5e-4)
        np.testing.assert_allclose(td[..., :4], jd[..., :4], rtol=0, atol=5e-4 * size)
    else:
        np.testing.assert_allclose(td[..., 4], jd[..., 4], rtol=0, atol=4 * 2.0 ** -8)
        np.testing.assert_allclose(td[..., :4], jd[..., :4], rtol=0, atol=4 * 2.0 ** -8 * size)


@pytest.mark.parametrize("dtype,class_wise,size", [("float32", False, 64), ("float32", False, 128),
                                                   ("float32", True, 128), ("bfloat16", False, 64),
                                                   ("bfloat16", True, 64)])
def test_predictor_nms_matches_jax(s_models, dtype, class_wise, size):
    jm, tm = s_models
    imgs = _images(1, s=size)
    kw = dict(imgsz=size, decode="nms", dtype=dtype, fuse=True, class_wise_nms=class_wise)
    jd, jn = JPredictor(jm, donate=False, **kw).run_batch(jnp.asarray(imgs))
    td, tn = Predictor(tm, device="cpu", **kw).run_batch(imgs)
    assert int(tn.min()) >= 3
    _assert_nms_dets(td.numpy(), tn.numpy(), jd, jn, size, dtype)


@pytest.mark.parametrize("decode", ["topk", "nms"])
@pytest.mark.parametrize("preprocess", ["host", "device"])
def test_predict_images_matches_jax(s_models, decode, preprocess):
    jm, tm = s_models
    rng = np.random.RandomState(12)
    imgs = [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in ((48, 80), (80, 48), (97, 61), (64, 64))]
    kw = dict(imgsz=64, decode=decode, fuse=True, conf_thresh=0.3)
    ref = JPredictor(jm, donate=False, **kw).predict_images(imgs, preprocess=preprocess)
    got = Predictor(tm, device="cpu", **kw).predict_images(imgs, preprocess=preprocess)
    assert len(got) == len(ref) == 4 and sum(len(g) for g in got) >= 4
    for g, r, img in zip(got, ref, imgs):
        assert g.shape == r.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g[:, 5], r[:, 5])
        np.testing.assert_allclose(g[:, 4], r[:, 4], rtol=0, atol=5e-4)
        np.testing.assert_allclose(g[:, :4], r[:, :4], rtol=0, atol=5e-4 * max(img.shape))
        h, w = img.shape[:2]
        assert (g[:, [0, 2]] <= w).all() and (g[:, [1, 3]] <= h).all() and (g[:, :4] >= 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decode", ["topk", "nms"])
def test_update_params_equals_a_new_predictor(s_models, dtype, decode):
    """After a load (an unfolded model, or a folded state dict), the
    predictor answers as a new predictor built on the loaded model: the
    packed kernel weights are packed again."""
    _, tm = s_models
    _, other = _setup("yolov10s", 80, 8)
    imgs = _images(3)
    kw = dict(imgsz=64, decode=decode, dtype=dtype, fuse=True, device="cpu")
    want_d, want_n = Predictor(other, **kw).run_batch(imgs)
    pred = Predictor(tm, **kw)
    before, _ = pred.run_batch(imgs)
    assert not torch.equal(before, want_d)
    pred.update_params(other)
    got_d, got_n = pred.run_batch(imgs)
    assert torch.equal(got_d, want_d) and torch.equal(got_n, want_n)
    pred = Predictor(tm, **kw)
    pred.update_params(Predictor(other, **kw).model.state_dict())
    got_d, got_n = pred.run_batch(imgs)
    assert torch.equal(got_d, want_d) and torch.equal(got_n, want_n)
