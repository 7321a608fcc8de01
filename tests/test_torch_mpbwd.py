"""The SPPF max-pool backward of the port (kernels/mpbwd.py, the autograd
Function `layers.maxpool2d_same`) against the JAX package.

On the CPU the wrapper runs its plain version. It reproduces the TPU kernel
`experiments/exp_sppf_bwd.py::mpbwd_pallas` (Pallas in interpret mode) bit
for bit: the same first-max routing and the same f32 summation order. XLA's
select-and-scatter (`jax.vjp` of `maxpool2d_same`, what the JAX trainer
runs) routes the same way but sums in the operand dtype: in fp32 the two
differ by rounding only, so the limit is 1e-5 of max|dy|. The SPPF block's
gradients, through convs and batch-stat BN, hold to < 5e-4 of their scale,
the port's fp32 parity rule.
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
from jax.experimental.pallas import tpu as pltpu

from leanyolo_tpu.models.yolov10 import layers as JL
from leanyolo_tpu_torch import kernels
from leanyolo_tpu_torch.kernels import mpbwd
from leanyolo_tpu_torch.models.yolov10 import layers as TL
from leanyolo_tpu_torch.models.yolov10.convert import flatten_param_paths, load_jax_params, path_to_torch_key
from torch_parity import nhwc_to_torch, randomize_bn, torch_to_nhwc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments"))

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed: int, shape, ties: bool):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2  # halves: many windows hold their max more than once
    return x, rng.randn(*shape).astype(np.float32)


def _pair(x: np.ndarray, dy: np.ndarray, dtype: str):
    """The same values as JAX arrays and torch tensors of `dtype`."""
    jd, td = DTYPES[dtype]
    xj, dyj = jnp.asarray(x, jd), jnp.asarray(dy, jd)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(td)
    return xj, dyj, to_t(xj), to_t(dyj)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("block_b", [1, 2])
def test_plain_bit_equal_to_pallas_kernel(dtype, ties, block_b):
    from exp_sppf_bwd import mpbwd_pallas

    x, dy = _inputs(0, (2, 20, 20, 16), ties)
    xj, dyj, xt, dyt = _pair(x, dy, dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = mpbwd_pallas(xj, dyj, k=5, block_b=block_b)
    ref_t = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(DTYPES[dtype][1])
    got = mpbwd.mpbwd(xt, dyt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_array_equal(_bits(got), _bits(ref_t))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape,k", [((2, 20, 20, 16), 5), ((3, 13, 17, 5), 5), ((1, 9, 7, 4), 3)])
def test_plain_matches_xla_select_and_scatter_fp32(ties, shape, k):
    x, dy = _inputs(1, shape, ties)
    ref = np.asarray(jax.vjp(lambda t: JL.maxpool2d_same(t, k), jnp.asarray(x))[1](jnp.asarray(dy))[0])
    got = mpbwd.mpbwd(torch.from_numpy(x), torch.from_numpy(dy), k).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(dy))
    # The routes agree exactly: the same positions receive gradient.
    np.testing.assert_array_equal(got != 0, ref != 0)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x, dy = _inputs(2, (2, 8, 8, 4), True)
    n = dict(kernels.LAUNCHES)
    got = mpbwd.mpbwd(torch.from_numpy(x), torch.from_numpy(dy))
    assert kernels.LAUNCHES == n  # no kernel launch on the CPU
    assert torch.equal(got, mpbwd.mpbwd_plain(torch.from_numpy(x), torch.from_numpy(dy)))


def test_mpbwd_and_topk_bounds():
    """Bytes bound both: x, dy in and dx out (19.66 MB, 0.00587 ms at
    [32,20,20,256] bf16); the top-k pair of a request, its rows in and the
    values and int32 indices out (0.00065 ms)."""
    from leanyolo_tpu_torch.kernels import bounds

    rows = {r[0]: r for r in bounds.kernel_bounds()}
    assert rows["mpbwd"][2] == 3 * 32 * 20 * 20 * 256 * 2 and rows["mpbwd"][-1] == "bytes"
    assert abs(rows["mpbwd"][-2] - 0.00587) < 1e-5
    assert rows["topk"][2] == 32 * (8400 + 24000) * 2 + 2 * 32 * 300 * 6 and abs(rows["topk"][-2] - 0.00065) < 1e-5


@pytest.mark.parametrize("dtype,c,offset,want", [(torch.bfloat16, 256, 0, "vec"), (torch.bfloat16, 40, 0, "vec"),
                                                  (torch.bfloat16, 36, 0, "general"), (torch.float32, 36, 0, "vec"),
                                                  (torch.float32, 6, 0, "general"), (torch.bfloat16, 64, 1, "general")])
def test_route_by_shape(dtype, c, offset, want):
    """The 16-byte route takes C holding whole 16-byte vectors (8 bf16, 4
    fp32) in 16-byte aligned tensors (the train step's [B,20,20,256]); the
    general route the rest."""
    shape = (2, 20, 20, c)
    buf = torch.zeros(2 * 20 * 20 * c + 16, dtype=dtype)
    x = buf[offset:offset + 2 * 20 * 20 * c].view(shape)  # PyTorch's buffers are 64-byte aligned
    dy = torch.zeros(shape, dtype=dtype)
    assert mpbwd.route(x, dy, torch.empty_like(dy)) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_autograd_function(dtype):
    """Forward is F.max_pool2d; backward is the plain mpbwd of the NHWC view."""
    x, dy = _inputs(3, (2, 12, 12, 8), True)
    _, _, xt, dyt = _pair(x, dy, dtype)
    xc = xt.permute(0, 3, 1, 2).clone().requires_grad_()
    y = TL.maxpool2d_same(xc, 5)
    assert torch.equal(y, torch.nn.functional.max_pool2d(xc.detach(), 5, 1, 2))
    y.backward(dyt.permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_bits(xc.grad.permute(0, 2, 3, 1).contiguous()), _bits(mpbwd.mpbwd_plain(xt, dyt)))


def test_maxpool_autograd_matches_jax_vjp_fp32():
    x, dy = _inputs(4, (2, 10, 10, 6), False)
    ref = np.asarray(jax.vjp(lambda t: JL.maxpool2d_same(t, 5), jnp.asarray(x))[1](jnp.asarray(dy))[0])
    xc = nhwc_to_torch(x).requires_grad_()
    TL.maxpool2d_same(xc, 5).backward(nhwc_to_torch(dy))
    assert np.max(np.abs(torch_to_nhwc(xc.grad) - ref)) <= 1e-5 * np.max(np.abs(dy))


@pytest.mark.parametrize("train", [False, True])
def test_sppf_gradients_match_jax(train):
    """The SPPF block (1x1, three chained pools, concat, 1x1) in fp32: the
    gradients of the input and of every parameter against jax.vjp of
    `sppf_apply`, with eval-mode BN and with batch-stat BN."""
    rng = np.random.RandomState(5)
    params = randomize_bn(JL.sppf_init(jax.random.PRNGKey(5), 32, 32), rng)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    x[:, 2:5, 2:5] = np.round(x[:, 2:5, 2:5])  # some ties inside the pooled map
    dy = rng.randn(2, 8, 8, 32).astype(np.float32)

    fn = functools.partial(JL.sppf_apply, train=train, stats=JL.BNStats() if train else None)
    _, vjp = jax.vjp(lambda p, t: fn(p, t), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))

    module = load_jax_params(TL.SPPF(32, 32), params).train(train)
    xt = nhwc_to_torch(x).requires_grad_()
    module(xt).backward(nhwc_to_torch(dy))

    gx = np.asarray(gx)
    assert np.max(np.abs(torch_to_nhwc(xt.grad) - gx)) < 5e-4 * max(1.0, np.max(np.abs(gx)))
    named = dict(module.named_parameters())
    checked = 0
    for path, g in flatten_param_paths(gp):
        key = path_to_torch_key(path)
        if key not in named:
            continue  # BN running statistics: buffers, no gradient
        g = np.asarray(g)
        if g.ndim == 4:
            g = g.transpose(3, 2, 0, 1)
        got = named[key].grad.numpy()
        assert np.max(np.abs(got - g)) < 5e-4 * max(1.0, np.max(np.abs(g))), key
        checked += 1
    assert checked == len(named)
