"""The port's 1x1-conv matrix product (kernels/matmul.py, the folded
`layers.MatmulConv`) against the JAX package.

On the CPU the wrapper runs its plain version: an fp32 sum rounded once to
the input's dtype. Against the TPU kernel `experiments/exp_pallas_mm.py::
pallas_mm` (Pallas in interpret mode) the two differ only in the order of
the fp32 sum: fp32 to 1e-5 of the output scale; bf16, where a different
order can flip one rounding, to 1 ulp of the output's largest magnitude
(ulp = 2^(e-7) for a value in [2^e, 2^(e+1))).

The folded serving forward sends every dense 1x1 conv through the bmm
wrapper and the stage-1 3x3 convs through s2dconv, counted per request.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from leanyolo_tpu_torch import Predictor, YOLOv10, kernels
from leanyolo_tpu_torch.kernels import bounds, matmul, s2dconv
from leanyolo_tpu_torch.models.yolov10 import layers as TL
from leanyolo_tpu_torch.models.yolov10.fold import fold_model, fold_module

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments"))

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# Dense 1x1 convs of one yolov10s serving request (one2one branch): backbone
# 20 (C2f cv1/cv2 x4 = 8, SCDown cv1 x2, C2fCIB c8 cv1/cv2 + its CIB's two
# 1x1s, SPPF 2, PSA cv1/cv2/qkv/proj/ffn x2 = 6), neck 13 (two upsample-concat
# C2f: cv1 in two halves + cv2 = 3 each, C2f 2, SCDown 1, C2fCIB 4), head 12
# (per level: the reg branch's last conv, the cls branch's two 1x1s and its
# last conv).
BMM_PER_REQUEST = {"yolov10s": 45, "yolov10n": 43}
S2D_PER_REQUEST = {"yolov10s": 2, "yolov10n": 6}  # n: c4.m.0-1 and p4_p3.m.0, 32 wide


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    aj = jnp.asarray(a, jd)
    return aj, torch.from_numpy(np.array(aj.astype(jnp.float32))).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,m,k,n", [(2, 100, 64, 48), (2, 37, 96, 80), (1, 64, 128, 128), (3, 25, 72, 33)])
def test_plain_matches_pallas_mm(dtype, b, m, k, n):
    from exp_pallas_mm import pallas_mm

    rng = np.random.RandomState(0)
    xj, xt = _pair((rng.randn(b, m, k) * 0.5).astype(np.float32), dtype)
    wj, wt = _pair((rng.randn(k, n) * 0.1).astype(np.float32), dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_mm(xj, wj).astype(jnp.float32))
    got = matmul.bmm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == ref.shape
    err = np.max(np.abs(got.float().numpy() - ref))
    if dtype == "float32":
        assert err <= 1e-5 * max(1.0, np.max(np.abs(ref))), err
    else:
        assert err <= 2.0 ** (np.floor(np.log2(np.max(np.abs(ref)))) - 7), err


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 30, 96).astype(np.float32))[..., 32:]  # a channel slice
    w = torch.from_numpy(rng.randn(64, 40).astype(np.float32))
    n = dict(kernels.LAUNCHES)
    got = matmul.bmm(x, w)
    assert kernels.LAUNCHES == n  # no kernel launch on the CPU
    assert torch.equal(got, matmul.bmm_plain(x.contiguous(), w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_conv_matches_conv2d(dtype):
    """MatmulConv against the cuDNN-form conv it replaces, whole and by
    input-channel range (the upsample-concat halves)."""
    g = torch.Generator().manual_seed(2)
    conv = TL.Conv(48, 24, 1, bias=True, generator=g)
    mm = TL.MatmulConv(conv).to(dtype)
    conv = conv.to(dtype)
    x = torch.randn(2, 48, 6, 5, generator=g).to(dtype)
    with torch.no_grad():
        for lo, hi in ((0, None), (0, 20), (20, None)):
            ref = conv.conv(x[:, lo:hi], lo, hi).float()
            got = mm.conv(x[:, lo:hi], lo, hi).float()
            limit = 1e-5 if dtype == torch.float32 else 2.0 ** -7  # one bf16 rounding flip
            assert float((got - ref).abs().max()) <= limit * max(1.0, float(ref.abs().max()))
        ref = conv(x).float()
        assert float((mm(x).float() - ref).abs().max()) <= limit * max(1.0, float(ref.abs().max()))
    assert "wt" not in mm.state_dict()


def test_fold_routes_dense_1x1_convs():
    folded = fold_module(TL.C2f(16, 32, 1, shortcut=False))
    assert type(folded.cv1.conv) is TL.MatmulConv and type(folded.cv2.conv) is TL.MatmulConv
    assert torch.equal(folded.cv1.conv.wt, folded.cv1.conv.weight[:, :, 0, 0].t())
    sd = {k: torch.randn_like(v) for k, v in folded.state_dict().items()}
    folded.load_state_dict(sd)
    assert torch.equal(folded.cv1.conv.wt, sd["cv1.conv.weight"][:, :, 0, 0].t())  # packed again
    # Depthwise and strided convs keep cuDNN.
    sc = fold_module(TL.SCDown(16, 32))
    assert type(sc.cv1.conv) is TL.MatmulConv and type(sc.cv2.conv) is TL.Conv


@pytest.mark.parametrize("name", ["yolov10s", "yolov10n"])
def test_folded_serving_request_goes_through_both_wrappers(name, monkeypatch):
    """Predictor.run_batch on the CPU, the wrappers counted per request."""
    calls = {"bmm": 0, "s2dconv": 0}
    bmm, conv3 = matmul.bmm, s2dconv.conv3x3_c32_bias_silu

    def count(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(matmul, "bmm", count("bmm", bmm))
    monkeypatch.setattr(s2dconv, "conv3x3_c32_bias_silu", count("s2dconv", conv3))
    model = YOLOv10.create(name, class_names=[f"c{i}" for i in range(80)], seed=0)
    pred = Predictor(model, imgsz=64, dtype="bfloat16", fuse=True, device="cpu")
    imgs = np.random.RandomState(3).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    for request in range(2):
        dets, num = pred.run_batch(imgs)
        assert tuple(dets.shape) == (2, 84, 6)  # max_det capped at the 84 anchors of 64 px
        assert calls == {"bmm": BMM_PER_REQUEST[name] * (request + 1), "s2dconv": S2D_PER_REQUEST[name] * (request + 1)}
    assert sum(isinstance(m, TL.S2DConvBNAct) for m in pred.model.modules()) == S2D_PER_REQUEST[name]


def test_path_bounds():
    """The bounds script's serving shapes: 45 bmm calls at 640, M = H*W."""
    shapes = bounds.serving_1x1_shapes("yolov10s", 640)
    assert len(shapes) == BMM_PER_REQUEST["yolov10s"]
    assert shapes[0] == (160 * 160, 64, 64) and shapes[-1] == (20 * 20, 128, 80)
    (name, _, nbytes, _, ms, by), (name2, *_) = bounds.path_bounds()
    assert name == "s2dconv" and name2 == "bmm" and by == "bytes"
    assert nbytes == 2 * (2 * 32 * 160 * 160 * 32 + 4 * 128 * 128 + 32)
    assert abs(ms - nbytes / bounds.HBM_BYTES_PER_S * 1e3) < 1e-12


def test_fold_model_unfolded_paths_keep_cudnn():
    """Neither TPU kernel has a backward: the unfolded (training) model keeps
    cuDNN convs, and folding leaves the source model untouched."""
    model = YOLOv10.create("yolov10n", class_names=["a"], seed=0)
    fold_model(model)
    assert not any(isinstance(m, (TL.MatmulConv, TL.S2DConvBNAct)) for m in model.modules())
    x = torch.randn(1, 32, 4, 4)
    conv = model.backbone.c2.cv1.conv
    assert torch.equal(conv.conv(x), F.conv2d(x, conv.weight))
