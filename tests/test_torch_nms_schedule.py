"""A numpy model of the NMS kernel's schedule (leanyolo_tpu_torch/kernels/csrc/nms.cu)
against the JAX package's greedy NMS on the CPU.

The kernel walks the score-sorted ranks a block of 32 at a time: it settles
each block's survivors from the block's diagonal IoUs (Jacobi sweeps to their
first fixed point), then tests the later candidates still alive against all
of those survivors, and the compaction stops at the block whose survivors
fill its k_out = min(max_det, n) slots.
The CUDA kernel cannot run here; this model runs the same schedule on the
same arithmetic (each IoU operation an IEEE fp32 operation, rounded to bf16
in the bf16 mode), and the tests hold its keep sets, detections and counts
bit-equal to JAX's `nms_fixed` and `_nms_single`, at block edges and in both
modes, and hold `kernels/bounds.py::nms_pairs` to the pairs the model
evaluates.
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
from leanyolo_tpu_torch.kernels import bounds
from leanyolo_tpu_torch.kernels import nms as knms

BLOCK = 32
OFFSET = 81920.0


def bf16(x) -> np.ndarray:
    """fp32 -> bf16, round to nearest even, kept as fp32 (finite inputs)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


class Schedule:
    """The kernel's arithmetic and walk on one image's candidates."""

    def __init__(self, boxes, valid, iou_thresh: float, bf16_mode: bool, cls=None, class_wise: bool = False):
        self.rnd = bf16 if bf16_mode else _f32
        q = _f32(boxes)
        if class_wise:
            off = self.rnd(_f32(cls) * np.float32(self.rnd(np.float32(OFFSET))))
            q = self.rnd(q + off[:, None])
        self.box = q
        self.area = self.rnd(np.maximum(self.rnd(q[:, 2] - q[:, 0]), 0) * np.maximum(self.rnd(q[:, 3] - q[:, 1]), 0))
        self.eps = self.rnd(np.float32(1e-9))
        self.thresh = self.rnd(np.float32(iou_thresh))
        self.valid = np.asarray(valid, bool)
        self.n = len(q)

    def suppresses(self, p: np.ndarray, c: np.ndarray) -> np.ndarray:
        """[len(p), len(c)]: iou(p_i, c_j) > thresh, boxes.py:37-46's operations."""
        r, a, b = self.rnd, self.box[p][:, None], self.box[c][None]
        iw = np.maximum(r(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0])), 0)
        ih = np.maximum(r(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1])), 0)
        inter = r(iw * ih)
        uni = r(r(self.area[p][:, None] + self.area[c][None]) - inter)
        return r(inter / r(uni + self.eps)) > self.thresh

    def run(self, k_out=None):
        """(keep [n] bool, survivors in slot order, pairs evaluated, steps taken)."""
        n = self.n
        dead = ~self.valid.copy()
        keep = np.zeros(n, bool)
        slots, pairs, steps = [], 0, 0
        for s in range(0, n, BLOCK):
            e = min(s + BLOCK, n)
            steps += 1
            m = e - s
            pairs += m * (m - 1) // 2  # the block's diagonal words
            idx = np.arange(s, e)
            diag = self.suppresses(idx, idx) & (idx[:, None] < idx[None, :])
            live = ~dead[s:e]
            settled = live.copy()  # the settle: Jacobi sweeps to their first fixed point
            while True:
                nxt = live & ~diag[settled].any(0)
                if (nxt == settled).all():
                    break
                settled = nxt
            kept = list(s + np.flatnonzero(settled))
            keep[kept] = True
            slots += kept
            if (k_out is not None and len(slots) >= k_out) or e == n:
                break
            if kept:  # the survivors' rows against the later live candidates
                later = np.arange(e, n)[~dead[e:]]
                pairs += len(kept) * len(later)
                dead[later[self.suppresses(np.array(kept), later).any(0)]] = True
        return keep, slots, pairs, steps


def _boxes(seed: int, n: int, grid: bool):
    rng = np.random.RandomState(seed)
    if grid:  # integer corners: IoUs exactly at 0.5, 1/3, ...
        xy = rng.randint(0, 8, (n, 2)).astype(np.float32)
        wh = rng.randint(1, 5, (n, 2)).astype(np.float32)
    else:  # on a 0.25-px grid (bf16-exact below 64), overlapping
        xy = rng.randint(0, 160, (n, 2)) / 4
        wh = rng.randint(4, 80, (n, 2)) / 4
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32), rng


def test_bf16_rounding_is_torchs():
    x = np.random.RandomState(0).randn(100_000).astype(np.float32) * np.float32(1e3)
    x[:4] = [0.451, 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 2.0 ** -8)]  # ties round to even
    np.testing.assert_array_equal(bf16(x), torch.from_numpy(x).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 160])
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("grid,thresh", [(True, 0.5), (False, 0.45), (False, 0.451)])
def test_schedule_keep_bit_equal_to_jax(n, mode, grid, thresh):
    """Keep sets at block edges, with a valid mask, against JAX's
    nms_fixed(presorted=True, valid=) in fp32 or on bf16 arrays."""
    boxes, rng = _boxes(n + int(thresh * 1000), n, grid)
    valid = rng.uniform(size=n) < 0.8
    jd = jnp.bfloat16 if mode == "bf16" else jnp.float32
    ref = np.asarray(JB.nms_fixed(jnp.asarray(boxes, jd), jnp.zeros(n, jd), thresh, presorted=True,
                                  valid=jnp.asarray(valid)))
    keep, slots, _, steps = Schedule(boxes, valid, thresh, mode == "bf16").run()
    np.testing.assert_array_equal(keep, ref)
    assert slots == list(np.flatnonzero(ref)) and steps == -(-n // BLOCK)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("class_wise", [False, True])
@pytest.mark.parametrize("max_det", [1, 20, 300])
def test_schedule_compaction_bit_equal_to_jax(mode, class_wise, max_det):
    """The compaction's early stop at k_out = min(max_det, n): the model's
    first k_out survivors, as [box, score, cls] rows of the unshifted boxes,
    equal JAX's `_nms_single` (classes 0 and 79 among them)."""
    k = 200
    boxes, rng = _boxes(31 + max_det, k, False)
    scores = np.sort(np.round(rng.uniform(0, 1, k) * 64) / 64).astype(np.float32)[::-1].copy()
    cls = rng.choice([0, 1, 5, 79], k).astype(np.float32)
    jd = jnp.bfloat16 if mode == "bf16" else jnp.float32
    fn = jax.jit(jax.vmap(partial(jax_nms_single, iou_thresh=0.45, conf_thresh=0.25, max_det=max_det,
                                  class_wise=class_wise, group_offset=OFFSET)))
    rd, rn = fn(jnp.asarray(boxes[None], jd), jnp.asarray(scores[None], jd), jnp.asarray(cls[None], jd))
    rnd = bf16 if mode == "bf16" else _f32
    valid = rnd(scores) > rnd(np.float32(0.25))
    sched = Schedule(rnd(boxes), valid, 0.45, mode == "bf16", rnd(cls), class_wise)
    k_out = min(max_det, k)
    keep, slots, _, steps = sched.run(k_out)
    dets = np.zeros((max_det, 6), np.float32)
    rows = slots[:k_out]
    dets[:len(rows)] = np.concatenate([rnd(boxes)[rows], rnd(scores)[rows, None], rnd(cls)[rows, None]], axis=1)
    np.testing.assert_array_equal(int(rn[0]), len(rows))
    np.testing.assert_array_equal(dets.view(np.int32), np.asarray(rd[0], np.float32).view(np.int32))
    _, full_slots, _, full_steps = sched.run()
    assert full_slots[:k_out] == rows
    # The walk ends at the block of the survivor that fills the last slot.
    assert steps == (full_slots[k_out - 1] // BLOCK + 1 if len(full_slots) >= k_out else full_steps)


def test_block_with_every_candidate_suppressed():
    """A block whose 32 candidates all lie under an earlier survivor: the
    rows of block 0 kill them all, so block 1 settles nothing and its
    step walks no rows; a survivor at a block's last rank (31) counts."""
    base = [[0, 0, 10, 10]]
    apart = [[100 + 20 * i, 100, 110 + 20 * i, 110] for i in range(30)]  # ranks 1-30, disjoint
    boxes = np.array(base + apart + [[100, 500, 110, 510]] + base * 32 + [[100, 900, 110, 910]], np.float32)
    n = len(boxes)
    valid = np.ones(n, bool)
    keep, slots, pairs, steps = Schedule(boxes, valid, 0.45, False).run()
    ref = np.asarray(JB.nms_fixed(jnp.asarray(boxes), jnp.zeros(n), 0.45, presorted=True, valid=jnp.asarray(valid)))
    np.testing.assert_array_equal(keep, ref)
    assert keep[31] and not keep[32:64].any() and keep[64]
    assert steps == 3


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("k_out", [None, 1, 20, 300])
@pytest.mark.parametrize("grid", [True, False])
def test_nms_pairs_counts_the_schedule(mode, k_out, grid):
    """`bounds.nms_pairs` (torch, batched) counts the pairs the model
    evaluates and the survivors' rows, image by image."""
    imgs = [_boxes(70 + i, 150, grid) for i in range(3)]
    boxes = np.stack([b for b, _ in imgs])
    valid = np.stack([rng.uniform(size=150) < 0.8 for _, rng in imgs])
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    got = bounds.nms_pairs(torch.from_numpy(boxes).to(dt), 0.45, torch.from_numpy(valid), k_out=k_out)
    evaluated = needed = 0
    for b, v in zip(boxes, valid):
        keep, _, pairs, _ = Schedule(b, v, 0.45, mode == "bf16").run(k_out)
        full = Schedule(b, v, 0.45, mode == "bf16").run()[0]
        evaluated += pairs
        needed += int(((149 - np.arange(150)) * full).sum())
    assert got == (evaluated, needed)
    assert got[0] < 3 * 150 * 149 // 2


def test_kernel_wrapper_keep_equals_the_schedule():
    """The wrapper's plain version (what a CPU tensor gets) and the model
    agree on a grid with IoUs at the threshold, at n = 1000."""
    boxes, rng = _boxes(5, 1000, True)
    valid = rng.uniform(size=1000) < 0.9
    got = knms.nms_keep(torch.from_numpy(boxes)[None], 0.5, torch.from_numpy(valid)[None])[0].numpy()
    np.testing.assert_array_equal(got, Schedule(boxes, valid, 0.5, False).run()[0])
