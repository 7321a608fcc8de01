"""The port's space-to-depth 3x3 conv (kernels/s2dconv.py, the folded
`layers.S2DConvBNAct`) against the JAX package.

On the CPU the wrapper runs its plain version. The checks:

- `s2d`, `un_s2d` and `w_s2d_k3` are bit-equal to `experiments/exp_s2d.py`'s
  (pure data movement);
- the 3x3 SAME conv equals the 2x2 conv over the S2D form in fp32, to
  1e-5 of the output scale (only the order of fp32 sums differs);
- `s2d_conv_plain` with zero bias against the TPU kernels
  `experiments/exp_pallas_k2.py::pallas_k2` and every body of
  `experiments/exp_pallas_k2b.py::build`, Pallas in interpret mode. fp32:
  1e-5 of the output scale. bf16: the Pallas kernel applies SiLU to the
  fp32 sum and rounds once; the port rounds the sum, adds the bias, applies
  SiLU and rounds again, as the folded JAX forward does. The difference is
  at most ~1.55 ulps of the element (half an ulp of the sum through SiLU's
  slope <= 1.1, plus a rounding), so the limit is 2 ulps of the output's
  largest magnitude (ulp = 2^(e-7) for a value in [2^e, 2^(e+1)));
- a folded yolov10s-width bottleneck (32 channels, the stage-1 block) runs
  both convs through the wrapper and agrees with the JAX block as the other
  block tests do (fp32 < 5e-4 of scale, bf16 <= 8 ulps of 2^-8 each).
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from leanyolo_tpu.models.yolov10 import layers as JL
from leanyolo_tpu.models.yolov10.fold import fold_params
from leanyolo_tpu_torch import kernels
from leanyolo_tpu_torch.kernels import s2dconv
from leanyolo_tpu_torch.models.yolov10 import layers as TL
from leanyolo_tpu_torch.models.yolov10.convert import load_jax_params
from leanyolo_tpu_torch.models.yolov10.fold import fold_module
from torch_parity import as_f32, bf16_ulps, nhwc_to_torch, randomize_bn, torch_to_nhwc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments"))

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    jd, td = DTYPES[dtype]
    aj = jnp.asarray(a, jd)
    return aj, torch.from_numpy(np.array(aj.astype(jnp.float32))).to(td)


def _bf16_ulp_of_max(ref: np.ndarray) -> float:
    return 2.0 ** (np.floor(np.log2(np.max(np.abs(ref)))) - 7)


def _close_to_pallas(got: torch.Tensor, ref, dtype: str) -> None:
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.max(np.abs(got.float().numpy() - ref))
    limit = 1e-5 * max(1.0, np.max(np.abs(ref))) if dtype == "float32" else 2 * _bf16_ulp_of_max(ref)
    assert got.shape == ref.shape and err <= limit, (err, limit)


@pytest.mark.parametrize("shape,pad", [((2, 8, 12, 5), 0), ((2, 8, 12, 5), 1), ((1, 160, 160, 32), 1)])
def test_s2d_and_un_s2d_bit_equal_to_exp_s2d(shape, pad):
    import exp_s2d

    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ref = np.array(exp_s2d.s2d(jnp.asarray(x), pad=pad))
    got = s2dconv.s2d(torch.from_numpy(x), pad=pad).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(s2dconv.un_s2d(torch.from_numpy(ref)).numpy(), np.asarray(exp_s2d.un_s2d(jnp.asarray(ref))))


@pytest.mark.parametrize("ci,co", [(5, 7), (32, 32)])
def test_w_s2d_k3_bit_equal_to_exp_s2d(ci, co):
    import exp_s2d

    w = np.random.RandomState(1).randn(3, 3, ci, co).astype(np.float32)
    np.testing.assert_array_equal(s2dconv.w_s2d_k3(torch.from_numpy(w)).numpy(), exp_s2d.w_s2d_k3(w))


@pytest.mark.parametrize("h,w", [(16, 16), (10, 14), (9, 7)])
def test_3x3_same_equals_s2d_form_fp32(h, w):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, h, w, 32).astype(np.float32))
    wt = torch.from_numpy((rng.randn(32, 32, 3, 3) * 0.1).astype(np.float32))
    b = torch.from_numpy((rng.randn(32) * 0.1).astype(np.float32))
    ref = F.silu(F.conv2d(x.permute(0, 3, 1, 2), wt, b, 1, 1)).permute(0, 2, 3, 1)
    got = s2dconv.conv3x3_c32_bias_silu(x, s2dconv.pack_weights(wt), b)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_k2(dtype):
    from exp_pallas_k2 import pallas_k2

    rng = np.random.RandomState(3)
    xj, xt = _pair(rng.randn(1, 81, 81, 128).astype(np.float32), dtype)
    wj, wt = _pair((rng.randn(4, 128, 128) * 0.05).astype(np.float32), dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_k2(xj, wj)
    _close_to_pallas(s2dconv.s2d_conv_plain(xt, wt, torch.zeros(128, dtype=xt.dtype)), ref, dtype)


@pytest.mark.parametrize("body", ["k_v0", "k_v1", "k_v2", "k_v3", "k_v4"])
def test_plain_matches_k2b_bodies(body):
    """Each body of `build` (bf16 output): v3 in one block of 4 images, v1
    through the all-(0, 0) tap table its "no slicing" form reads."""
    import exp_pallas_k2b

    nimg = 4 if body == "k_v3" else 1
    rng = np.random.RandomState(4)
    xj, xt = _pair(rng.randn(nimg, 81, 81, 128).astype(np.float32), "bfloat16")
    wj, wt = _pair((rng.randn(4, 128, 128) * 0.05).astype(np.float32), "bfloat16")
    with pltpu.force_tpu_interpret_mode():
        ref = exp_pallas_k2b.build(getattr(exp_pallas_k2b, body), nimg, nimg=nimg)(xj, wj)
    taps = ((0, 0),) * 4 if body == "k_v1" else s2dconv.TAPS
    _close_to_pallas(s2dconv.s2d_conv_plain(xt, wt, torch.zeros(128, dtype=torch.bfloat16), taps), ref, "bfloat16")


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 8, 6, 64).astype(np.float32))[..., 32:]  # a channel slice
    w = s2dconv.pack_weights(torch.from_numpy(rng.randn(32, 32, 3, 3).astype(np.float32)))
    b = torch.from_numpy(rng.randn(32).astype(np.float32))
    n = dict(kernels.LAUNCHES)
    got = s2dconv.conv3x3_c32_bias_silu(x, w, b)
    assert kernels.LAUNCHES == n  # no kernel launch on the CPU
    assert torch.equal(got, s2dconv.conv3x3_c32_bias_silu_plain(x.contiguous(), w, b))
    with pytest.raises(ValueError):
        s2dconv._taps_bits(((0, 0), (0, 2), (1, 0), (1, 1)))


def test_fold_packs_the_s2d_weights():
    rng = np.random.RandomState(6)
    params = randomize_bn(JL.bottleneck_init(jax.random.PRNGKey(6), 32, 32), rng)
    folded = fold_module(load_jax_params(TL.Bottleneck(32, 32, shortcut=True), params).eval())
    for m in (folded.cv1, folded.cv2):
        assert type(m) is TL.S2DConvBNAct and m.folded
        assert torch.equal(m.w_s2d, s2dconv.pack_weights(m.conv.weight))
    assert "cv1.w_s2d" not in folded.state_dict()  # packed weights stay out of the state dict
    # A state-dict load packs again.
    sd = {k: torch.randn_like(v) for k, v in folded.state_dict().items()}
    folded.load_state_dict(sd)
    assert torch.equal(folded.cv1.w_s2d, s2dconv.pack_weights(sd["cv1.conv.weight"]))
    assert folded.cv1.w_s2d.stride() == (128, 1, 512)  # packed K-major again
    # Other 3x3 convs keep cuDNN.
    other = fold_module(load_jax_params(TL.Bottleneck(16, 16, shortcut=True),
                                        JL.bottleneck_init(jax.random.PRNGKey(6), 16, 16)))
    assert type(other.cv1) is TL.ConvBNAct


def test_pack_weights_k_major_round_trip():
    """pack_weights holds the S2D weights K-major ([128 N, 512 K] storage, the
    wgmma route's layout) behind a [4, 128, 128] view; k_major takes that
    storage with no copy and makes the same matrix from any other layout."""
    w = torch.from_numpy(np.random.RandomState(8).randn(32, 32, 3, 3).astype(np.float32))
    packed = s2dconv.pack_weights(w)
    assert packed.shape == (4, 128, 128) and packed.stride() == (128, 1, 512)
    assert torch.equal(packed, s2dconv.w_s2d_k3(w.permute(2, 3, 1, 0)).reshape(4, 128, 128))
    wk = s2dconv.k_major(packed)
    assert wk.shape == (128, 512) and wk.is_contiguous() and wk.data_ptr() == packed.data_ptr()
    assert torch.equal(wk.t().reshape(4, 128, 128), packed)  # (k, n) of tap-major K at wk[n, k]
    dense = packed.contiguous()
    assert torch.equal(s2dconv.k_major(dense), wk)
    # Casting and the channels_last conversion of a module keep the view K-major.
    m = fold_module(load_jax_params(TL.Bottleneck(32, 32, shortcut=True),
                                    JL.bottleneck_init(jax.random.PRNGKey(8), 32, 32)).eval())
    m = m.to(torch.bfloat16).to(memory_format=torch.channels_last)
    assert m.cv1.w_s2d.stride() == (128, 1, 512)
    assert s2dconv.k_major(m.cv1.w_s2d).data_ptr() == m.cv1.w_s2d.data_ptr()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_folded_bottleneck_c32_matches_jax(dtype, monkeypatch):
    rng = np.random.RandomState(7)
    params = randomize_bn(JL.bottleneck_init(jax.random.PRNGKey(7), 32, 32), rng)
    x = rng.randn(2, 12, 10, 32).astype(np.float32)
    jd, td = DTYPES[dtype]
    fp = fold_params(params, dtype=None if dtype == "float32" else jd)
    ref = as_f32(jax.jit(functools.partial(JL.bottleneck_apply, shortcut=True))(fp, jnp.asarray(x, jd)))
    module = fold_module(load_jax_params(TL.Bottleneck(32, 32, shortcut=True), params).eval()).to(td)
    calls = []
    wrapper = s2dconv.conv3x3_c32_bias_silu
    monkeypatch.setattr(s2dconv, "conv3x3_c32_bias_silu", lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    with torch.no_grad():
        got = torch_to_nhwc(module(nhwc_to_torch(x, td)))
    assert len(calls) == 2
    err = np.max(np.abs(got - ref))
    assert err < (5e-4 * max(1.0, np.max(np.abs(ref))) if dtype == "float32" else bf16_ulps(ref, 8)), err
