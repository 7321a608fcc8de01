"""The training BatchNorm's batch moments (K8, kernels/bnstats.py) against
the JAX package on the CPU, where the wrappers run the plain versions.

- Forward: mean and unbiased variance of `_BatchMoments` against JAX's
  `_bn_act` train branch, read through `BNStats.record`. Tolerance: 5e-4 of
  scale, the repo's fp32 rule: the mean against the largest |mean|, the
  variance against the largest E[y^2], the scale of the two terms it is the
  difference of. bf16 inputs take the same tolerance: both packages convert
  the bf16 values to fp32 exactly and add in fp32, so only the order of the
  fp32 sums differs.
- The cancellation case (mean 1000, std 0.01) apart: there the variance is
  rounding noise of s2/n, which both packages clamp at 0, so it is checked
  for the clamp and held under a few ulps of E[y^2], not against JAX's
  noise; the mean is held to 2 fp32 ulps of the exact mean and to a tenth
  of the std of JAX's.
- Backward: the input gradient against `jax.vjp` of the same moments with
  random cotangents. fp32: 5e-4 of the gradient's scale. bf16: besides, one
  bf16 ulp of each element: both packages round an fp32 gradient to bf16,
  and fp32 values that differ in their last bits can round to neighbouring
  bf16 values.
- The plain version's order: bits equal between channels_last and
  contiguous copies, and equal to a numpy float32 spelling of the order the
  module doc states, on an input where a plain sequential sum gives other
  bits.
- CPU tensors launch nothing; the work counts by hand; the shapes of a
  yolov10s training step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10 import layers as JL
from leanyolo_tpu_torch import kernels
from leanyolo_tpu_torch.kernels import bnstats, bounds
from leanyolo_tpu_torch.models.yolov10 import layers as TL

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# [N, C, H, W]; multi_block: 128 slots of 32 lanes, 128 rows each.
SHAPES = {"c16": (2, 16, 5, 7), "c33": (2, 33, 4, 6), "one_row": (1, 16, 1, 1), "multi_block": (4, 16, 64, 64)}
TOL = 5e-4


def _input(case: str, seed: int = 0) -> np.ndarray:
    """NCHW fp32 numpy input of a case."""
    rng = np.random.RandomState(seed)
    if case == "signed_zeros":
        y = np.round(rng.randn(2, 16, 6, 6) * 2) / 2
        y[(y == 0) & (rng.rand(*y.shape) < 0.5)] = -0.0
        return y.astype(np.float32)
    if case == "cancellation":
        return (1000.0 + 0.01 * rng.randn(2, 16, 8, 8)).astype(np.float32)
    n, c, h, w = SHAPES[case]
    return (rng.randn(n, c, h, w) * 1.5 + rng.randn(1, c, 1, 1)).astype(np.float32)


def _jax_moments(y_nhwc):
    """(mean, unbiased var) of JAX's `_bn_act` train branch, from BNStats."""
    c = y_nhwc.shape[-1]
    bn = {"scale": jnp.ones(c), "bias": jnp.zeros(c), "mean": jnp.zeros(c), "var": jnp.ones(c)}
    st = JL.BNStats()
    JL._bn_act({"bn": bn}, y_nhwc, act=False, train=True, stats=st, scope="bn")
    return st.updates["bn"]["mean"], st.updates["bn"]["var"]


def _torch_moments(y: torch.Tensor):
    """(mean, unbiased var) of the port's training BN (`_BatchMoments`,
    advanced as BatchNorm._advance advances the running variance)."""
    n = y.numel() // y.shape[1]
    mean, var = TL._BatchMoments.apply(y, None)
    return mean, var * (n / max(n - 1, 1))


def _rel(a, b, scale) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(scale, 1e-30))


def _both(y_np: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    yj = jnp.asarray(y_np.transpose(0, 2, 3, 1)).astype(jd)
    yt = torch.from_numpy(y_np).to(td).contiguous(memory_format=torch.channels_last)
    return yj, yt


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", [*SHAPES, "signed_zeros"])
def test_moments_match_jax(case, dtype):
    yj, yt = _both(_input(case), dtype)
    jm, jv = (np.asarray(a) for a in _jax_moments(yj))
    with torch.no_grad():
        tm, tv = (a.numpy() for a in _torch_moments(yt))
    square = np.asarray(yj.astype(jnp.float32), np.float64) ** 2
    assert _rel(tm, jm, np.abs(jm).max()) <= TOL
    assert _rel(tv, jv, square.mean(axis=(0, 1, 2)).max()) <= TOL
    assert (tv >= 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cancellation_clamps_variance(dtype):
    """Mean 1000, std 0.01: s2/n - mean^2 is rounding noise (bf16 rounds every
    value to 1000, so there it is 0). The mean is held to 2 fp32 ulps of the
    exact mean and to a tenth of the std of JAX's; the variance only to the
    clamp and to 8 ulps of E[y^2], the size of that noise."""
    yj, yt = _both(_input("cancellation"), dtype)
    jm, _ = (np.asarray(a) for a in _jax_moments(yj))
    with torch.no_grad():
        tm, tv = (a.numpy() for a in _torch_moments(yt))
    y64 = np.asarray(yj.astype(jnp.float32), np.float64)
    exact = y64.mean(axis=(0, 1, 2))
    assert np.abs(tm - exact).max() <= 2 * np.spacing(np.float32(1000))
    assert np.abs(tm - jm).max() <= 0.1 * 0.01
    assert (tv >= 0).all()
    assert tv.max() <= 8 * np.spacing(np.float32((y64**2).mean()))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", [*SHAPES, "signed_zeros"])
def test_backward_matches_jax_vjp(case, dtype):
    y_np = _input(case, seed=1)
    c = y_np.shape[1]
    rng = np.random.RandomState(2)
    g_mean, g_var = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    yj, yt = _both(y_np, dtype)
    _, vjp = jax.vjp(_jax_moments, yj)
    (gj,) = vjp((jnp.asarray(g_mean), jnp.asarray(g_var)))
    gj = np.asarray(gj.astype(jnp.float32)).transpose(0, 3, 1, 2)
    yt.requires_grad_(True)
    mean, uvar = _torch_moments(yt)
    (gt,) = torch.autograd.grad((mean, uvar), yt, (torch.from_numpy(g_mean), torch.from_numpy(g_var)))
    assert gt.dtype == yt.dtype and gt.shape == yt.shape
    gt = gt.float().numpy()
    gap = np.abs(gt.astype(np.float64) - gj)
    allowed = TOL * np.abs(gj).max()
    if dtype == "bfloat16":
        allowed = allowed + np.abs(gj) * 2.0 ** -8
    assert (gap <= allowed).all(), float((gap - allowed).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 16, 5, 7), (3, 33, 17, 19), (1, 64, 40, 40)])
def test_plain_bits_equal_across_layouts(shape, dtype):
    y = torch.from_numpy(np.random.RandomState(3).randn(*shape).astype(np.float32) * 4).to(DTYPES[dtype][1])
    a = bnstats.bn_moments_plain(y.contiguous())
    b = bnstats.bn_moments_plain(y.contiguous(memory_format=torch.channels_last))
    assert all(torch.equal(x.view(torch.int32), z.view(torch.int32)) for x, z in zip(a, b))
    g1, g2 = torch.randn(shape[1]), torch.randn(shape[1])
    da = bnstats.bn_moments_bwd_plain(y.contiguous(), g1, g2)
    db = bnstats.bn_moments_bwd_plain(y.contiguous(memory_format=torch.channels_last), g1, g2)
    assert torch.equal(da, db) and db.is_contiguous(memory_format=torch.channels_last)


def _documented_order(x: np.ndarray):
    """s1, s2 of x [rows, C] float32 in the order of kernels/bnstats.py's
    module doc, one float32 operation at a time."""
    rows, c = x.shape
    lanes = bnstats.LANES
    g = bnstats.slots(rows, c)
    f = np.float32

    def tree(a):
        h = 1
        while h < lanes:
            for l in range(0, lanes, 2 * h):
                a[l] = f(a[l] + a[l + h])
            h *= 2
        return a[0]

    out = np.zeros((2, c), np.float32)
    for ch in range(c):
        a1 = [[f(0.0)] * lanes for _ in range(g)]
        a2 = [[f(0.0)] * lanes for _ in range(g)]
        for r in range(rows):  # in step order: a lane's rows come in increasing r
            slot, l, v = (r // lanes) % g, r % lanes, x[r, ch]
            a1[slot][l] = f(a1[slot][l] + v)
            a2[slot][l] = f(a2[slot][l] + f(v * v))
        for m, a in enumerate((a1, a2)):
            parts = [tree(a[slot]) for slot in range(g)]
            h = 1
            while h < g:  # the slots' pairwise tree
                for i in range(0, g, 2 * h):
                    parts[i] = f(parts[i] + parts[i + h])
                h *= 2
            out[m, ch] = parts[0]
    return out


def test_plain_version_pins_the_documented_order():
    # Values over twelve decades with both signs: the order of the additions
    # decides the last bits. 3 x 13 x 13 = 507 rows, C = 3: 8 slots of 32
    # lanes, two steps, the second of them partial.
    rng = np.random.RandomState(4)
    y = (np.exp(rng.uniform(-14, 14, (3, 3, 13, 13))) * rng.choice([-1.0, 1.0], (3, 3, 13, 13))).astype(np.float32)
    x = y.transpose(0, 2, 3, 1).reshape(-1, 3)
    assert (bnstats.slots(507, 3), bnstats.rows_per_lane(507, 3)) == (8, 2)
    want = _documented_order(x)
    s1, s2 = bnstats.bn_moments_plain(torch.from_numpy(y))
    assert np.array_equal(s1.numpy().view(np.int32), want[0].view(np.int32))
    assert np.array_equal(s2.numpy().view(np.int32), want[1].view(np.int32))
    sequential = np.zeros(3, np.float32)
    for row in x:
        sequential = sequential + row
    assert not np.array_equal(sequential, want[0])  # another order gives other bits here


@pytest.mark.parametrize("rows, c, g, r", [(3276800, 32, 256, 400), (819200, 64, 256, 100), (204800, 128, 128, 50),
                                           (51200, 256, 64, 25), (12800, 512, 32, 13), (12800, 256, 64, 7),
                                           (12800, 64, 128, 4), (507, 3, 8, 2), (1, 33, 1, 1),
                                           (10 ** 8, 16, 256, 12208)])
def test_rows_per_lane_by_shape(rows, c, g, r):
    """The slots G (a power of two, G C <= 16,384, 32 G <= rows, G <= 128,
    or 256 above 2^18 rows) and the steps of a lane, at the step's shapes and
    at both ends."""
    assert bnstats.slots(rows, c) == g
    assert bnstats.rows_per_lane(rows, c) == r


def test_empty_input_gives_zero_sums():
    s1, s2 = bnstats.bn_moments(torch.zeros(0, 5, 3, 3))
    assert torch.equal(s1, torch.zeros(5)) and torch.equal(s2, torch.zeros(5))


def test_routes_by_layout_and_width():
    y = torch.zeros(2, 64, 4, 4, dtype=torch.bfloat16)
    assert bnstats.route(y.contiguous(memory_format=torch.channels_last)) == "vec"
    assert bnstats.route(y) == "general"  # contiguous NCHW
    assert bnstats.route(torch.zeros(2, 33, 4, 4).contiguous(memory_format=torch.channels_last)) == "general"
    assert bnstats.route(torch.zeros(2, 36, 4, 4).contiguous(memory_format=torch.channels_last)) == "vec"  # fp32


def test_cpu_tensors_launch_nothing():
    before = dict(kernels.LAUNCHES)
    bn = TL.BatchNorm(16).train()
    y = torch.randn(2, 16, 5, 5, requires_grad=True)
    bn(y).square().sum().backward()
    bnstats.bn_moments_bwd(y.detach(), torch.ones(16), torch.ones(16))
    assert kernels.LAUNCHES == before and y.grad is not None


def test_bn_moments_work_counts_each_byte_once():
    rows = 32 * 320 * 320
    assert bounds.bn_moments_work(rows, 32, 2) == (rows * 32 * 2 + 2 * 32 * 4, 3 * rows * 32)
    assert bounds.bn_moments_bwd_work(rows, 32, 2) == (2 * rows * 32 * 2 + 2 * 32 * 4, 3 * rows * 32)
    assert bounds.bn_moments_work(12800, 33, 4) == (12800 * 33 * 4 + 264, 3 * 12800 * 33)
    ms, by = bounds.bound(*bounds.bn_moments_work(rows, 32, 2), bounds.FP32_OPS_PER_S)
    assert by == "bytes" and abs(ms - (rows * 64 + 256) / 3.35e12 * 1e3) < 1e-12


def test_train_bn_shapes_of_yolov10s():
    shapes = bounds.train_bn_shapes("yolov10s", 640, 32)
    assert len(shapes) == 99 and len(set(shapes)) == 14
    assert sum(n * c * h * w for n, c, h, w in shapes) == 1_274_675_200
    assert max(shapes, key=lambda s: s[1] * s[2] * s[3]) == (32, 32, 320, 320)
    fwd = sum(bounds.bound(*bounds.bn_moments_work(n * h * w, c))[0] for n, c, h, w in shapes)
    bwd = sum(bounds.bound(*bounds.bn_moments_bwd_work(n * h * w, c))[0] for n, c, h, w in shapes)
    assert 0.75 < fwd < 0.77 and 1.51 < bwd < 1.53  # ms: 2.55 GB read, then also 2.55 GB written, at 3.35 TB/s
