"""The port's greedy NMS and fused max/argmax (leanyolo_tpu_torch/ops/boxes.py,
ops/topk.py, kernels/nms.py, kernels/argmax.py) against the JAX package on
the CPU, where the kernel wrappers run their plain versions.

Keep masks, counts, classes and indices are bit-exact; so are the maxima
(both sides take the same fp32 or bf16 value). Inputs come from numpy seeds;
boxes on an integer grid make IoUs land exactly on the threshold.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10.decode import _nms_single as jax_nms_single
from leanyolo_tpu.ops import boxes as JB
from leanyolo_tpu.ops.topk import max_argmax_lastdim as jax_max_argmax
from leanyolo_tpu_torch.kernels import argmax as kargmax
from leanyolo_tpu_torch.kernels import nms as knms
from leanyolo_tpu_torch.models.yolov10.decode import _nms_single
from leanyolo_tpu_torch.ops import boxes as TB
from leanyolo_tpu_torch.ops.topk import max_argmax_lastdim


def _boxes(seed: int, n: int, grid: bool):
    """xyxy boxes in a 64-px field; `grid`: integer corners, so many IoUs are
    exact ratios of small integers (0.5, 1/3, ...)."""
    rng = np.random.RandomState(seed)
    if grid:
        xy = rng.randint(0, 8, (n, 2)).astype(np.float32)
        wh = rng.randint(1, 5, (n, 2)).astype(np.float32)
    else:
        xy = rng.uniform(0, 48, (n, 2)).astype(np.float32)
        wh = rng.uniform(2, 20, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=1), rng.uniform(0, 1, n).astype(np.float32), rng


@pytest.mark.parametrize("schedule,block", [("blocked", 64), ("blocked", 7), ("jacobi", 64)])
@pytest.mark.parametrize("presorted", [True, False])
@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("grid,thresh", [(False, 0.45), (True, 0.5), (True, 1 / 3)])
def test_nms_fixed_keep_bit_equal(schedule, block, presorted, with_valid, grid, thresh):
    boxes, scores, rng = _boxes(int(thresh * 100) + block, 150, grid)
    if presorted:
        order = np.argsort(-scores, kind="stable")
        boxes, scores = boxes[order], scores[order]
    valid = rng.uniform(size=150) < 0.7 if with_valid else None
    ref = JB.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), thresh, schedule=schedule, block=block,
                       presorted=presorted, valid=None if valid is None else jnp.asarray(valid))
    got = TB.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, schedule=schedule, block=block,
                       presorted=presorted, valid=None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.sum() < 150


@pytest.mark.parametrize("thresh", [0.5, 1 / 3])
def test_iou_exactly_at_threshold_is_kept(thresh):
    """IoU == thresh (in fp32) does not suppress: [0,0,4,1] and [0,0,2,1]
    have IoU 2/4; [0,0,3,1] and [0,0,1,1] 1/3, equal to fp32(1/3)."""
    b = np.array([[0, 0, 4, 1], [0, 0, 2, 1], [0, 0, 3, 1], [0, 0, 1, 1], [0, 0, 4, 1]], np.float32)
    if thresh != 0.5:
        b = b[[2, 3, 0]]
    got = TB.nms_fixed(torch.from_numpy(b), torch.zeros(len(b)), thresh, presorted=True).numpy()
    ref = np.asarray(JB.nms_fixed(jnp.asarray(b), jnp.zeros(len(b)), thresh, presorted=True))
    np.testing.assert_array_equal(got, ref)
    assert got[0] and got[1]  # the exact tie keeps the second box
    assert not got[-1] if thresh == 0.5 else True  # an identical box (IoU 1) goes


def test_alive_schedules_equal_the_plain_nms():
    """`_alive_blocked` and `_alive_jacobi` (plain PyTorch) equal the NMS
    kernel's plain version and JAX's schedules."""
    boxes, _, rng = _boxes(3, 120, True)
    valid = rng.uniform(size=120) < 0.8
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    plain = knms.nms_keep_plain(tb[None], 0.5, tv[None])[0]
    np.testing.assert_array_equal(TB._alive_blocked(tb, 0.5, 16, tv).numpy(), plain.numpy())
    np.testing.assert_array_equal(TB._alive_blocked(tb, 0.5, 16, tv).numpy(),
                                  np.asarray(JB._alive_blocked(jnp.asarray(boxes), 0.5, 16, jnp.asarray(valid))))
    np.testing.assert_array_equal(TB._alive_jacobi(tb, 0.5).numpy(), knms.nms_keep_plain(tb[None], 0.5)[0].numpy())
    np.testing.assert_array_equal(TB._alive_jacobi(tb, 0.5).numpy(), np.asarray(JB._alive_jacobi(jnp.asarray(boxes), 0.5)))


@pytest.mark.parametrize("schedule,presorted", [("blocked", True), ("blocked", False), ("jacobi", True)])
def test_nms_fixed_picks_the_schedule_as_jax(monkeypatch, schedule, presorted):
    """Presorted input and the blocked schedule run `_alive_blocked` with
    min(block, n) ranks a block (JAX `nms_fixed`); on the CPU that is the
    blocked substitution, not the kernel wrapper's plain version."""
    boxes, scores, _ = _boxes(4, 30, True)
    seen = []
    blocked = TB._alive_blocked
    monkeypatch.setattr(TB, "_alive_blocked", lambda *a: seen.append(a[2]) or blocked(*a))
    monkeypatch.setattr(knms, "nms_keep", lambda *a, **k: pytest.fail("the CPU route reached the kernel wrapper"))
    TB.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, schedule=schedule, block=64,
                 presorted=presorted)
    assert seen == ([] if schedule == "jacobi" and not presorted else [30])


@pytest.mark.parametrize("class_wise", [True, False])
@pytest.mark.parametrize("max_det", [300, 40])
def test_nms_single_matches_jax(class_wise, max_det):
    """Candidates in score order with classes up to 79: class-wise, the boxes
    shift by cls * 81920 (6.47e6 at class 79, where fp32's spacing is 0.5
    px), and the keep set is that of the shifted boxes."""
    k = 200
    boxes, _, rng = _boxes(11, k, False)
    boxes = boxes * 4 + np.float32(0.37)  # off the half-pixel grid, so the shift rounds
    scores = np.sort(rng.uniform(0, 1, k).astype(np.float32))[::-1].copy()
    cls = rng.choice([0, 1, 78, 79], k).astype(np.float32)
    fn = jax.jit(jax.vmap(partial(jax_nms_single, iou_thresh=0.45, conf_thresh=0.25, max_det=max_det,
                                  class_wise=class_wise, group_offset=81920.0)))
    rd, rn = fn(jnp.asarray(boxes[None]), jnp.asarray(scores[None]), jnp.asarray(cls[None]))
    gd, gn = _nms_single(torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]), torch.from_numpy(cls[None]),
                         iou_thresh=0.45, conf_thresh=0.25, max_det=max_det, class_wise=class_wise)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    assert gd.shape == (1, max_det, 6) and int(gn[0]) > 10


def test_class_offset_changes_the_keep_set():
    """The offset trick's rounding is load-bearing: at class 79 the shifted
    boxes' IoU differs from the raw boxes', and the port keeps JAX's set
    (not the set a class-equality test would give)."""
    base = np.array([[100.3, 100.1, 140.3, 140.1]], np.float32)
    shifts = np.linspace(0, 20, 64, dtype=np.float32)[:, None] * np.array([[1, 0, 1, 0]], np.float32)
    boxes = (base + shifts).astype(np.float32)
    scores = np.linspace(0.9, 0.3, 64).astype(np.float32)
    cls = np.full(64, 79.0, np.float32)
    raw, _ = _nms_single(torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]), torch.from_numpy(cls[None]),
                         iou_thresh=0.7, conf_thresh=0.0, max_det=64, class_wise=False)
    got, gn = _nms_single(torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]), torch.from_numpy(cls[None]),
                          iou_thresh=0.7, conf_thresh=0.0, max_det=64, class_wise=True)
    fn = jax.jit(jax.vmap(partial(jax_nms_single, iou_thresh=0.7, conf_thresh=0.0, max_det=64, class_wise=True,
                                  group_offset=81920.0)))
    rd, rn = fn(jnp.asarray(boxes[None]), jnp.asarray(scores[None]), jnp.asarray(cls[None]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(rn))
    assert not np.array_equal(got.numpy(), raw.numpy())


def _zero_rows(dtype, seed: int):
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(64, 80) * 2) / 2
    x[:8] = 0.0
    x[:8, ::3] = -0.0  # rows of signed zeros, -0.0 first in some
    x[8:16] = -np.abs(x[8:16])
    x[8:16, 5] = -0.0
    x[8:16, 40] = 0.0  # a max of +0.0 after a -0.0
    x[16:20] = -0.0  # all -0.0
    x[20] = -np.abs(x[20]) - 1.0
    x[20, :2] = [-0.0, 0.0]
    return x.astype(np.float32), (jnp.bfloat16 if dtype == "bfloat16" else jnp.float32), \
        (torch.bfloat16 if dtype == "bfloat16" else torch.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_max_argmax_lastdim_bit_equal(dtype):
    """bf16: the packed route (-0.0 ties +0.0, the max of zeros is +0.0);
    fp32: the two-reduce route (the max of [-0.0, 0.0] is +0.0, where
    torch.amax gives -0.0; the argmax is index 0 of that row)."""
    x, jd, td = _zero_rows(dtype, 0)
    rv, ri = jax_max_argmax(jnp.asarray(x, jd))
    gv, gi = max_argmax_lastdim(torch.from_numpy(x).to(td))
    assert gv.dtype == td and gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    np.testing.assert_array_equal(gv.float().numpy().view(np.uint32) if dtype == "float32" else
                                  gv.view(torch.int16).numpy().view(bits), np.asarray(rv).view(bits))
    assert int(gi[20]) == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_max_argmax_fp32_rule_on_bf16_equals_the_upcast(dtype):
    """Ranked as fp32 (the NMS decode's rule on bf16 maps), the fused
    max/argmax gives what JAX's two-reduce route gives on the fp32 upcast,
    as fp32 values."""
    x, jd, td = _zero_rows(dtype, 1)
    xj = jnp.asarray(x, jd).astype(jnp.float32)
    rv, ri = jnp.max(xj, axis=-1), jnp.argmax(xj, axis=-1)
    gv, gi = max_argmax_lastdim(torch.from_numpy(x).to(td), dtype=torch.float32)
    assert gv.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy().view(np.uint32), np.asarray(rv).view(np.uint32))


def test_max_argmax_levels_write_at_offsets():
    rng = np.random.RandomState(2)
    levels = [torch.from_numpy(np.round(rng.randn(2, n, 80) * 2).astype(np.float32)) for n in (64, 16, 4)]
    vals, idx = max_argmax_lastdim(levels)
    assert vals.shape == idx.shape == (2, 84)
    off = 0
    for lv in levels:
        v, i = kargmax.max_argmax_plain(lv, canon_zero=False)
        assert torch.equal(vals[:, off:off + lv.shape[1]], v) and torch.equal(idx[:, off:off + lv.shape[1]], i)
        off += lv.shape[1]


def test_box_format_conversions_match_jax():
    boxes, _, _ = _boxes(5, 50, False)
    t = torch.from_numpy(boxes)
    np.testing.assert_array_equal(TB.box_xyxy_to_xywh(t).numpy(), np.asarray(JB.box_xyxy_to_xywh(jnp.asarray(boxes))))
    xywh = TB.box_xyxy_to_xywh(t)
    np.testing.assert_array_equal(TB.box_xywh_to_xyxy(xywh).numpy(),
                                  np.asarray(JB.box_xywh_to_xyxy(jnp.asarray(xywh.numpy()))))


# bf16 arithmetic (the JAX decode's NMS on bf16 maps): each IoU operation
# rounded to bf16, the threshold rounded to bf16 by JAX's weak typing.
BF16_THRESHOLDS = (0.45, 0.451, 0.5, 1 / 3)  # 0.451 rounds up to 0.451171875 in bf16


def _bf16_boxes(seed: int, n: int):
    """bf16-exact xyxy boxes on a 0.25-px grid in a 60-px field, many pairs
    overlapping, so that bf16 IoUs fall on the format's rounding edges (a
    bf16 IoU differs from the rounded fp32 one on some of them)."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 160, (n, 2)) / 4
    wh = rng.randint(4, 80, (n, 2)) / 4
    b = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    return b, torch.from_numpy(b).to(torch.bfloat16), jnp.asarray(b, jnp.bfloat16)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def test_bf16_iou_bit_equal_to_jax():
    b, tb, jb = _bf16_boxes(21, 300)
    ref = _bits(JB.box_iou(jb, jb).astype(jnp.float32))
    for got in (knms.iou_matrix(tb), TB.box_iou(tb, tb)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got.float().numpy()), ref)
    upcast = _bits(torch.from_numpy(np.array(JB.box_iou(jb.astype(jnp.float32), jb.astype(jnp.float32))))
                   .to(torch.bfloat16).float().numpy())
    assert (upcast != ref).sum() > 100  # its own arithmetic, not the fp32 IoU rounded


@pytest.mark.parametrize("thresh", BF16_THRESHOLDS)
@pytest.mark.parametrize("with_valid", [True, False])
def test_bf16_keep_bit_equal_to_jax(thresh, with_valid):
    b, tb, jb = _bf16_boxes(22, 400)
    valid = np.random.RandomState(3).uniform(size=400) < 0.8 if with_valid else None
    ref = np.asarray(JB.nms_fixed(jb, jnp.zeros(400, jnp.bfloat16), thresh, presorted=True,
                                  valid=None if valid is None else jnp.asarray(valid)))
    tv = None if valid is None else torch.from_numpy(valid)
    got = knms.nms_keep_plain(tb[None], thresh, None if tv is None else tv[None])[0]
    np.testing.assert_array_equal(got.numpy(), ref)
    for schedule in ("blocked", "jacobi"):
        np.testing.assert_array_equal(TB.nms_fixed(tb, torch.zeros(400, dtype=torch.bfloat16), thresh,
                                                   schedule=schedule, presorted=True, valid=tv).numpy(), ref)


def test_bf16_threshold_rounds_as_jax():
    """An IoU of exactly bf16(0.451) = 0.451171875 is not above a threshold of
    0.451 in bf16 (JAX rounds the threshold), though it is above 0.451 in fp32."""
    boxes = np.array([[0, 0, 1, 1], [0, 0, 1, 0.451171875]], np.float32)
    assert float(knms.iou_matrix(torch.from_numpy(boxes).to(torch.bfloat16))[0, 1]) == 0.451171875
    ref = np.asarray(JB.nms_fixed(jnp.asarray(boxes, jnp.bfloat16), jnp.zeros(2, jnp.bfloat16), 0.451,
                                  presorted=True))
    got = knms.nms_keep_plain(torch.from_numpy(boxes).to(torch.bfloat16)[None], 0.451)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [True, True]
    assert knms.nms_keep_plain(torch.from_numpy(boxes)[None], 0.451)[0].tolist() == [True, False]


@pytest.mark.parametrize("class_wise", [False, True])
@pytest.mark.parametrize("thresh", [0.45, 0.451])
def test_nms_single_bf16_matches_jax(class_wise, thresh):
    """`_nms_single` on bf16 candidates: the valid test, the class shift and
    the IoUs in bf16, the payload the bf16 values in fp32, as JAX's."""
    k = 300
    _, tb, jb = _bf16_boxes(23, k)
    rng = np.random.RandomState(24)
    scores = np.sort(np.round(rng.uniform(0, 1, k) * 64) / 64).astype(np.float32)[::-1].copy()
    cls = rng.choice([0, 1, 5, 79], k).astype(np.float32)
    fn = jax.jit(jax.vmap(partial(jax_nms_single, iou_thresh=thresh, conf_thresh=0.25, max_det=100,
                                  class_wise=class_wise, group_offset=81920.0)))
    rd, rn = fn(jb[None], jnp.asarray(scores[None], jnp.bfloat16), jnp.asarray(cls[None], jnp.bfloat16))
    gd, gn = _nms_single(tb[None], torch.from_numpy(scores[None]).to(torch.bfloat16),
                         torch.from_numpy(cls[None]).to(torch.bfloat16), iou_thresh=thresh, conf_thresh=0.25,
                         max_det=100, class_wise=class_wise)
    assert gd.dtype == torch.float32
    np.testing.assert_array_equal(gn.numpy(), np.asarray(rn))
    np.testing.assert_array_equal(_bits(gd.numpy()), _bits(np.asarray(rd)))
    assert int(gn[0]) > 10
