"""Plain versions of the port's kernels against the JAX functions they replace.

On the CPU every kernel wrapper runs its plain PyTorch version; these tests
hold that version against the TPU kernels (Pallas in interpret mode) and the
JAX package's own functions. The CUDA kernels themselves are held against
the plain versions on the card (tests/test_torch_kernels_cuda.py and
chip_smoke.py).

Tolerances: bf16 outputs are compared to 4 bf16 ulps (2^-8 each) of the
output's largest magnitude: the Pallas kernels keep the bias and SiLU in
fp32 and round once, the port rounds after the conv, the bias and the SiLU,
as the folded JAX forward does; the sums also run in another order. fp32
comparisons hold to < 5e-4. Top-k indices and values are bit-exact.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10 import layers as JL
from leanyolo_tpu.ops.topk import topk_lastdim as jax_topk
from leanyolo_tpu_torch.kernels import dwconv, stem, topk as ktopk
from leanyolo_tpu_torch.ops.topk import topk_lastdim
from torch_parity import as_f32, bf16_ulps

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments"))


def _stem_weights(rng, c0=32, c1=64):
    """Folded yolov10s-width stem weights (HWIO), normalization /255 folded in."""
    w0 = (rng.randn(3, 3, 3, c0) * 0.5).astype(np.float32)
    b0 = (rng.randn(c0) * 0.1).astype(np.float32)
    w1 = (rng.randn(3, 3, c0, c1) * 0.1).astype(np.float32)
    b1 = (rng.randn(c1) * 0.1).astype(np.float32)
    return w0, b0, w1, b1


def _t(w_hwio):
    return torch.from_numpy(w_hwio).permute(3, 2, 0, 1).contiguous()


def test_stem_plain_matches_pallas_fused_stem():
    from stem_pallas import fused_stem, prepare_stem_params

    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    w0, b0, w1, b1 = _stem_weights(rng)
    div = np.full(3, 255.0, np.float32)
    sp = prepare_stem_params(w0, b0, w1, b1, input_subtract=np.zeros(3, np.float32), input_divide=div)
    ref = as_f32(fused_stem(jnp.asarray(img), sp, t1=8, w1t=16, interpret=True))
    w0n = w0 / div[None, None, :, None]  # the normalization fold of fold.py
    got = stem.fused_stem_plain(torch.from_numpy(img), _t(w0n).bfloat16(), torch.from_numpy(b0).bfloat16(),
                                _t(w1).bfloat16(), torch.from_numpy(b1).bfloat16(), dtype=torch.bfloat16)
    assert got.shape == (2, 16, 16, 64)
    # The Pallas stem keeps conv0's bias in fp32 and rounds once; the folded
    # serving tree (and so the port) carries bf16 biases: compare at 4 ulps.
    assert np.max(np.abs(as_f32(got) - ref)) <= bf16_ulps(ref, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_plain_matches_jax_cba_pair(dtype):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    w0, b0, w1, b1 = _stem_weights(rng)
    w0 = w0 / 255.0
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    p0 = {"conv": {"w": jnp.asarray(w0, jd), "b": jnp.asarray(b0, jd)}}
    p1 = {"conv": {"w": jnp.asarray(w1, jd), "b": jnp.asarray(b1, jd)}}

    @jax.jit
    def ref_fn(x):
        y = JL.cba_apply(p0, x.astype(jd), stride=2)
        return JL.cba_apply(p1, y, stride=2)

    ref = as_f32(ref_fn(jnp.asarray(img)))
    ws = [t.to(td) for t in (_t(w0), torch.from_numpy(b0), _t(w1), torch.from_numpy(b1))]
    got = as_f32(stem.fused_stem(torch.from_numpy(img), *ws))
    tol = 5e-4 * max(1.0, np.max(np.abs(ref))) if dtype == "float32" else bf16_ulps(ref, 4)
    assert np.max(np.abs(got - ref)) <= tol


def _dw_inputs(seed, c=512):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 20, 20, c).astype(np.float32)
    w = (rng.randn(7, 7, 1, c) * 0.1).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    return x, w, b


def test_dw7x7_plain_matches_pallas_and_xla():
    from jax.experimental.pallas import tpu as pltpu

    import exp_dw_pallas as E

    x, w, b = _dw_inputs(0)
    xj = jnp.asarray(x, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref_pallas = as_f32(E.dw_pallas(xj, jnp.asarray(w), jnp.asarray(b)))
    ref_xla = as_f32(jax.jit(E.dw_xla)(xj, jnp.asarray(w), jnp.asarray(b)))
    got = as_f32(dwconv.dw7x7_bias_silu(torch.from_numpy(x).bfloat16(), dwconv.pack_weights(_t(w)), torch.from_numpy(b)))
    assert got.shape == (1, 20, 20, 512)
    assert np.max(np.abs(got - ref_pallas)) <= bf16_ulps(ref_pallas, 4)
    # dw_xla is the folded JAX forward's own rounding: bias and SiLU in bf16.
    assert np.max(np.abs(got - ref_xla)) <= bf16_ulps(ref_xla, 2)


def test_dw7x7_plain_fp32_matches_jax_cba():
    x, w, b = _dw_inputs(1, c=64)
    p = {"conv": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    ref = as_f32(jax.jit(lambda v: JL.cba_apply(p, v, groups=64, padding=3))(jnp.asarray(x)))
    got = as_f32(dwconv.dw7x7_bias_silu(torch.from_numpy(x), dwconv.pack_weights(_t(w)), torch.from_numpy(b)))
    assert np.max(np.abs(got - ref)) < 5e-4 * max(1.0, np.max(np.abs(ref)))


def _tie_heavy(rng, b, n, dtype):
    """Coarse values (many exact ties) with signed zeros sprinkled in."""
    x = np.round(rng.randn(b, n) * 4) / 4
    x[:, rng.rand(n) < 0.1] = -0.0
    x[:, rng.rand(n) < 0.1] = 0.0
    x = x.astype(np.float32)
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint16) if v.dtype.itemsize == 2 else v.view(np.uint32)


@pytest.mark.parametrize("n", [8400, 24000])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_topk_plain_bit_exact(n, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, xt = _tie_heavy(np.random.RandomState(n), 3, n, jd)
    rv, ri = jax.jit(lambda v: jax_topk(v, 300))(xj)
    gv, gi = topk_lastdim(xt, 300)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    gvn = gv.float().numpy().astype(np.asarray(rv).dtype) if dtype == "bfloat16" else gv.numpy()
    np.testing.assert_array_equal(_bits(gvn), _bits(rv))


@pytest.mark.parametrize("n", [2000, 8400])
@pytest.mark.parametrize("k", [1025, "n"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_topk_plain_bit_exact_past_1024(n, k, dtype):
    """No cap on k, as in JAX: k past the old 1024 and k == n (lax.top_k's
    route, where -0.0 ranks below +0.0), on tie-heavy rows.

    JAX runs eagerly here: under jit, XLA folds the packed bf16 route's
    `x + 0.0` (its -0.0 -> +0.0 step) where that route sorts the row in one
    piece (no block of n in [k, 2048], as for n = 2000, k = 1025), so the
    jitted function ranks -0.0 below +0.0 there, against its own docstring;
    eager JAX is the function as written, and the port follows it."""
    k = n if k == "n" else k
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, xt = _tie_heavy(np.random.RandomState(n + k), 2, n, jd)
    rv, ri = jax_topk(xj, k)
    gv, gi = topk_lastdim(xt, k)
    assert tuple(gi.shape) == (2, k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    gvn = gv.float().numpy().astype(np.asarray(rv).dtype) if dtype == "bfloat16" else gv.numpy()
    np.testing.assert_array_equal(_bits(gvn), _bits(rv))


@pytest.mark.parametrize("k", [1, 7])
def test_topk_plain_signed_zero_routes(k):
    """k == 1 and k == n take other JAX routes with other signed-zero rules."""
    x = np.array([[-0.0, 0.0, 1.0, -0.0, 0.0, 1.0, -1.0]], np.float32)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        rv, ri = jax_topk(jnp.asarray(x, jd), k)
        gv, gi = topk_lastdim(torch.from_numpy(x).to(td), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gv.float().numpy(), np.asarray(rv, np.float32))


def test_pack_unpack_roundtrip():
    x = torch.tensor([[-0.0, 0.0, 1.5, -2.25, float("inf"), -float("inf")]], dtype=torch.bfloat16)
    v, i = ktopk.unpack_bf16_desc(ktopk.pack_bf16_desc(x, canon_zero=False))
    assert torch.equal(i, torch.arange(6, dtype=torch.int32)[None])
    assert torch.equal(v.view(torch.int16), x.view(torch.int16))
    v, i = ktopk.unpack_f32_desc(ktopk.pack_f32_desc(x.float(), canon_zero=False))
    assert torch.equal(v.view(torch.int32), x.float().view(torch.int32))


def test_wrappers_raise_on_what_kernels_do_not_take():
    with pytest.raises(ValueError):
        ktopk.topk(torch.zeros(2, 10), 11, canon_zero=True)
    with pytest.raises(ValueError):  # k must be at least 1 (k has no upper cap but n)
        ktopk.topk(torch.zeros(2, 2000), 0, canon_zero=True)
