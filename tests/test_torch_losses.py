"""The port's training loss and assignment (ops/{anchors,boxes,topk,tal}.py,
models/yolov10/losses.py) against the JAX package, on the same numpy inputs.

Discrete outputs are bit-exact: top-k membership, and the TAL foreground
mask, GT indices, labels, one-hot scores and target boxes (a target box is
a copy of a GT box). Real-valued outputs are compared in fp32 within 1e-5
relative: both sides run the same formulas, and only transcendental
functions (atan, exp, log1p) may round one ulp apart. Gradients with
respect to the raw head maps hold to 1e-5 of the gradient's scale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10 import losses as JLoss
from leanyolo_tpu.ops import anchors as JA
from leanyolo_tpu.ops import boxes as JB
from leanyolo_tpu.ops import tal as JT
from leanyolo_tpu.ops.topk import topk_membership as jax_topk_membership
from leanyolo_tpu_torch.models.yolov10 import losses as TLoss
from leanyolo_tpu_torch.ops import anchors as TA
from leanyolo_tpu_torch.ops import boxes as TB
from leanyolo_tpu_torch.ops import tal as TT
from leanyolo_tpu_torch.ops.topk import topk_membership

NC = 6
REG_MAX = 16
HW = [(8, 8), (4, 4), (2, 2)]  # a 64 px input
STRIDES = (8, 16, 32)


def _rel(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) if got.size else 0.0
    assert err <= rel * max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0), err


def _boxes(rng, shape, size=64.0):
    xy = rng.uniform(0, size - 12, shape + (2,))
    wh = rng.uniform(2, 30, shape + (2,))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def _targets(seed: int, b: int = 2, n: int = 5):
    rng = np.random.RandomState(seed)
    gl = rng.randint(0, NC, (b, n)).astype(np.int32)
    gb = _boxes(rng, (b, n))
    gm = rng.uniform(size=(b, n)) < 0.7
    gm[:, 0] = True
    gm[-1] = False  # an image with no GT
    return gl, gb, gm


def _maps(seed: int, b: int = 2):
    """Per-level (reg, cls) NHWC maps, fp32. The DFL logits fall with the bin
    (expected distances near 1.3 cells), so predicted boxes are of GT size
    and overlap them: the assignment finds foreground."""
    rng = np.random.RandomState(seed)
    ramp = np.tile(-0.7 * np.arange(REG_MAX, dtype=np.float32), 4)
    return [((rng.randn(b, h, w, 4 * REG_MAX) + ramp).astype(np.float32),
             (rng.randn(b, h, w, NC) * 2 - 2).astype(np.float32)) for h, w in HW]


def test_bbox2dist_matches():
    rng = np.random.RandomState(0)
    anc = rng.uniform(0, 8, (20, 2)).astype(np.float32)
    bb = _boxes(rng, (3, 20), size=8.0)
    ref = np.asarray(JA.bbox2dist(jnp.asarray(anc)[None], jnp.asarray(bb), 15))
    got = TA.bbox2dist(torch.from_numpy(anc)[None], torch.from_numpy(bb), 15).numpy()
    np.testing.assert_array_equal(got, ref)


def test_box_area_and_iou_match():
    rng = np.random.RandomState(1)
    b1, b2 = _boxes(rng, (7,)), _boxes(rng, (9,))
    b1[0] = [5, 5, 3, 3]  # a degenerate box: area clamps to 0
    _rel(TB.box_area(torch.from_numpy(b1)).numpy(), np.asarray(JB.box_area(jnp.asarray(b1))))
    _rel(TB.box_iou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy(), np.asarray(JB.box_iou(jnp.asarray(b1), jnp.asarray(b2))))


def test_ciou_pairwise_and_paired_match_with_grads():
    rng = np.random.RandomState(2)
    b1, b2 = _boxes(rng, (6,)), _boxes(rng, (11,))
    b2[:6] = b1 + rng.uniform(-3, 3, b1.shape).astype(np.float32)  # overlapping pairs
    _rel(TB.box_ciou_pairwise(torch.from_numpy(b1), torch.from_numpy(b2)).numpy(),
         np.asarray(JB.box_ciou_pairwise(jnp.asarray(b1), jnp.asarray(b2))))

    p, t = b2[:6], b1
    ref, vjp = jax.vjp(lambda x: JB.box_ciou_paired(x, jnp.asarray(t)), jnp.asarray(p))
    (gref,) = vjp(jnp.ones_like(ref))
    pt = torch.from_numpy(p).requires_grad_()
    got = TB.box_ciou_paired(pt, torch.from_numpy(t))
    got.sum().backward()
    _rel(got.detach().numpy(), np.asarray(ref))
    gref = np.asarray(gref)
    assert np.max(np.abs(pt.grad.numpy() - gref)) <= 1e-5 * max(1e-3, np.max(np.abs(gref)))


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_membership_bit_exact(k, ties):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 84).astype(np.float32)
    if ties:
        x = np.round(x)
        x[0, 1] = 0.0  # a row of equal values: the lowest indices win
    ref = np.asarray(jax_topk_membership(jnp.asarray(x), k))
    got = topk_membership(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got.sum(-1) == k).all()


@pytest.mark.parametrize("topk", [10, 1])
def test_task_aligned_assign_bit_exact(topk):
    gl, gb, gm = _targets(4)
    rng = np.random.RandomState(5)
    a = sum(h * w for h, w in HW)
    anc, stride = (np.asarray(t) for t in JA.make_anchors(HW, STRIDES))
    anc_px = (anc * stride).astype(np.float32)
    pd_scores = rng.randn(2, a, NC).astype(np.float32)
    pd_boxes = np.concatenate([anc_px - rng.uniform(2, 20, (2, a, 2)), anc_px + rng.uniform(2, 20, (2, a, 2))], -1)
    pd_boxes = pd_boxes.astype(np.float32)
    gb[0, 1] = [0.1, 0.1, 0.2, 0.2]  # a GT holding no anchor centre: falls back to anchor 0

    ref = JT.task_aligned_assign(jnp.asarray(pd_scores), jnp.asarray(pd_boxes), jnp.asarray(anc_px), jnp.asarray(gl),
                                 jnp.asarray(gb), jnp.asarray(gm), topk=topk, num_classes=NC)
    got = TT.task_aligned_assign(torch.from_numpy(pd_scores), torch.from_numpy(pd_boxes), torch.from_numpy(anc_px),
                                 torch.from_numpy(gl), torch.from_numpy(gb), torch.from_numpy(gm), topk=topk,
                                 num_classes=NC)
    assert bool(np.asarray(ref.fg_mask).any())
    for name in ("fg_mask", "target_gt_idx", "target_labels", "target_scores", "target_bboxes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    mask_in = TT.select_candidates_in_gts(torch.from_numpy(anc_px), torch.from_numpy(gb)).numpy()
    np.testing.assert_array_equal(mask_in, np.asarray(JT.select_candidates_in_gts(jnp.asarray(anc_px), jnp.asarray(gb))))


def test_dfl_and_bce_match():
    rng = np.random.RandomState(6)
    logits = rng.randn(3, 10, 4 * REG_MAX).astype(np.float32)
    target = rng.uniform(-1, REG_MAX + 1, (3, 10, 4)).astype(np.float32)  # exercises the clip
    _rel(TLoss.dfl_loss(torch.from_numpy(logits), torch.from_numpy(target), REG_MAX).numpy(),
         np.asarray(JLoss.dfl_loss(jnp.asarray(logits), jnp.asarray(target), REG_MAX)))
    x = (rng.randn(50) * 10).astype(np.float32)
    t = rng.uniform(0, 1, 50).astype(np.float32)
    _rel(TLoss._bce_with_logits(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
         np.asarray(JLoss._bce_with_logits(jnp.asarray(x), jnp.asarray(t))))


@pytest.mark.parametrize("concat", [False, True])
def test_detection_loss_and_grads_match(concat):
    """Both branches (TAL top-k 10 and 1), every component, and the
    gradients of the total with respect to every raw map."""
    gl, gb, gm = _targets(7)
    raw_np = {"one2many": _maps(8), "one2one": _maps(9)}
    if concat:
        raw_np = {k: [np.concatenate(m, axis=-1) for m in v] for k, v in raw_np.items()}

    def jloss(raw):
        return JLoss.detection_loss_v10(raw, jnp.asarray(gl), jnp.asarray(gb), jnp.asarray(gm), num_classes=NC)

    jraw = jax.tree_util.tree_map(jnp.asarray, raw_np)
    ref = jloss(jraw)
    gref = jax.grad(lambda r: jloss(r)["total"])(jraw)

    traw = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).requires_grad_(), raw_np)
    got = TLoss.detection_loss_v10(traw, torch.from_numpy(gl), torch.from_numpy(gb), torch.from_numpy(gm),
                                   num_classes=NC)
    got["total"].backward()
    for k in ("total", "cls", "reg"):
        _rel(float(got[k].detach()), float(ref[k]))
    assert float(ref["reg"]) > 0 and float(ref["cls"]) > 0
    for t, g in zip(jax.tree_util.tree_leaves(traw), jax.tree_util.tree_leaves(gref)):
        g = np.asarray(g)
        assert np.max(np.abs(t.grad.numpy() - g)) <= 1e-5 * np.max(np.abs(g))


def test_detection_loss_one2many_only_and_no_gt():
    raw = _maps(10)
    gl, gb, gm = _targets(11)
    gm[:] = False
    ref = JLoss.detection_loss_v10([tuple(map(jnp.asarray, m)) for m in raw], jnp.asarray(gl), jnp.asarray(gb),
                                   jnp.asarray(gm), num_classes=NC)
    got = TLoss.detection_loss_v10([tuple(map(torch.from_numpy, m)) for m in raw], torch.from_numpy(gl),
                                   torch.from_numpy(gb), torch.from_numpy(gm), num_classes=NC)
    for k in ("total", "cls", "reg"):
        _rel(float(got[k]), float(ref[k]))


def test_build_padded_targets_matches():
    rng = np.random.RandomState(12)
    targets = [{"boxes": _boxes(rng, (n,)), "labels": rng.randint(0, NC, n)} for n in (3, 0, 9)]
    for ref, got in zip(JLoss.build_padded_targets(targets, 6), TLoss.build_padded_targets(targets, 6)):
        assert ref.dtype == got.dtype
        np.testing.assert_array_equal(got, ref)
