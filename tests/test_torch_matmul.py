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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [False, True])
def test_plain_epilogue_matches_jax_cba(dtype, act):
    """bmm_plain(x, w, bias, act) against the JAX folded `cba_apply` on a 1x1
    conv (conv rounded, + bias rounded, SiLU rounded): fp32 < 5e-4 of the
    output scale; bf16 within 1 ulp of the output's largest magnitude (the
    sums run in another order, so a rounding may land one step apart)."""
    from leanyolo_tpu.models.yolov10 import layers as JL

    rng = np.random.RandomState(4)
    x = (rng.randn(2, 6, 5, 96) * 0.5).astype(np.float32)
    w = (rng.randn(1, 1, 96, 40) * 0.1).astype(np.float32)
    b = (rng.randn(40) * 0.5).astype(np.float32)
    xj, xt = _pair(x, dtype)
    wj, wt = _pair(w, dtype)
    bj, bt = _pair(b, dtype)
    ref = np.asarray(JL.cba_apply({"conv": {"w": wj, "b": bj}}, xj, act=act).astype(jnp.float32))
    got = matmul.bmm(xt.reshape(2, 30, 96), wt[0, 0], bt, act).reshape(2, 6, 5, 40)
    assert got.dtype == xt.dtype
    err = np.max(np.abs(got.float().numpy() - ref))
    if dtype == "float32":
        assert err < 5e-4 * max(1.0, np.max(np.abs(ref))), err
    else:
        assert err <= 2.0 ** (np.floor(np.log2(np.max(np.abs(ref)))) - 7), err


def _spy_bmm_epilogues(monkeypatch):
    kinds = {"bias+silu": 0, "bias": 0, "neither": 0}
    bmm = matmul.bmm

    def spy(x, w, bias=None, act=False):
        assert bias is not None or not act
        kinds["bias+silu" if act else "bias" if bias is not None else "neither"] += 1
        return bmm(x, w, bias, act)

    monkeypatch.setattr(matmul, "bmm", spy)
    return kinds


def test_folded_request_fuses_bias_and_silu_into_bmm(monkeypatch):
    """Of a yolov10s request's 45 bmm calls, 32 carry bias + SiLU (ConvBNAct
    with act), 9 the bias alone (the six one2one head convs, PSA's qkv, proj
    and ffn.1) and 4 neither (the upsample-concat halves, whose bias follows
    the upsample-add)."""
    kinds = _spy_bmm_epilogues(monkeypatch)
    model = fold_model(YOLOv10.create("yolov10s", class_names=[f"c{i}" for i in range(80)], seed=0))
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3), dtype=torch.bfloat16, branches=("one2one",), normalize=False,
              concat_head=False)
    assert kinds == {"bias+silu": 32, "bias": 9, "neither": 4}


def test_fused_epilogue_changes_no_numbers(monkeypatch):
    """The folded bf16 yolov10n with bias and SiLU in bmm's epilogue gives
    the same one2one head maps, bit for bit, as with them as separate ops
    (the rounding points are the same); both stay within the JAX package's
    tolerance of tests/test_torch_model.py (4 bf16 ulps of the map scale)."""
    import jax

    from leanyolo_tpu.models.yolov10.fold import fold_params
    from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10, model_apply
    from leanyolo_tpu_torch.models.yolov10.convert import load_jax_params
    from torch_parity import bf16_ulps, randomize_bn

    jm = JYOLOv10.create("yolov10n", class_names=[f"c{i}" for i in range(8)], seed=5)
    params = randomize_bn(jm.params, np.random.RandomState(5))
    model = load_jax_params(YOLOv10.create("yolov10n", class_names=jm.class_names), params).eval()
    folded = fold_model(model, dtype=torch.bfloat16)
    imgs = np.random.RandomState(6).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    kw = dict(branches=("one2one",), normalize=False, concat_head=False)

    def maps():
        with torch.no_grad():
            out = folded(torch.from_numpy(imgs), dtype=torch.bfloat16, **kw)["one2one"]
        return [t.float().numpy() for level in out for t in level]

    fused = maps()
    monkeypatch.setattr(TL.ConvBNAct, "forward", lambda self, x: self.epilogue(self.conv.conv(x)))
    monkeypatch.setattr(TL.MatmulConv, "forward", TL.Conv.forward)
    separate = maps()
    fn = jax.jit(lambda p, x: model_apply(p, x.astype(jnp.bfloat16), jm.cfg, train=False, **kw))
    ref = jax.tree_util.tree_leaves(fn(fold_params(params, dtype=jnp.bfloat16), jnp.asarray(imgs))["one2one"])
    assert len(fused) == len(separate) == len(ref) == 6
    for f, s, r in zip(fused, separate, ref):
        r = np.asarray(r.astype(jnp.float32))
        assert np.array_equal(f, s)
        assert np.max(np.abs(f - r)) <= bf16_ulps(r, 4)


@pytest.mark.parametrize("rows,n,plan", [
    (32 * 25600, 64, (64, 2)),    # stage 1's C2f convs: 6400 tiles
    (32 * 6400, 80, (80, 2)),     # P3's cls conv
    (32 * 400, 80, (80, 1)),      # P5's cls conv: 100 tiles
    (32 * 400, 256, (128, 1)),    # 20x20, 200 tiles: one pair, the whole ring
    (32 * 400, 512, (128, 2)),    # 20x20, 400 tiles
    (32 * 1600, 256, (128, 2)),
    (37, 8, (64, 1)),
])
def test_wgmma_plan(rows, n, plan):
    """The wgmma route's tile width and consumer pairs per path shape (132 SMs)."""
    assert matmul.wgmma_plan(rows, n) == plan
