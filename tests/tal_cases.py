"""Inputs of the task-aligned assignment's test cases, made with numpy from a
seed (tests/test_torch_tal_kernel.py against JAX on the CPU,
tests/test_torch_kernels_cuda.py and chip_smoke.py kernel against plain on
the card).

`tal_case(name, seed)` -> dict of numpy arrays: pd_scores [B, A, NC] logits
(or, with "concat", the whole concatenated head rows [B, A, REG + NC], whose
class slice [..., REG:] the caller passes as a strided view), pd_bboxes
[B, A, 4] and anc [A, 2] in pixels, gt_labels [B, N] int32, gt_bboxes
[B, N, 4], mask_gt [B, N] bool, and "spot": what a built case must show
(see `CASES`). Padded slots keep real boxes, as a batch's draws do.
"""

from __future__ import annotations

import numpy as np

NC = 6
REG = 64  # 4 * reg_max values before the classes in a concatenated head row

# name: what the case holds.
CASES = {
    "masked_wins": "two valid GTs claim an anchor whose predicted box equals a padded slot's box: the padded slot "
                   "wins the highest-CIoU resolve",
    "fallback": "a GT holding no anchor centre, and one whose anchors all align at 0 so it falls back to anchor 0",
    "few_positive": "fewer than k positive aligns: anchors of align 0 inside the GT join the set in index order",
    "twins": "two identical GT boxes of one label: every anchor they both claim ties on CIoU, the lower slot wins",
    "k_ge_a": "a 32 px image at strides 16 and 32: A = 5, so k = 10 takes every anchor",
    "n1": "one GT slot an image",
    "n16": "16 slots, 40% valid at random positions",
    "n128": "128 slots",
    "concat": "the concatenated head's class slice, a strided view",
    "all_masked": "an image with every slot padded",
    "full_size": "640 px (A = 8400), 80 classes, 16 slots 40% valid with boxes 8-60 px",
    "nan_logit": "a NaN logit (of a valid GT's class) on an anchor outside every box: the anchor's score is NaN for "
                 "every GT row of the image, as JAX's one-hot contraction makes it, so each row's best align is NaN",
    "inf_box": "a predicted box with an infinite coordinate, at an anchor outside every box: NaN CIoU, so NaN align",
    "huge_box": "predicted boxes of coordinates 1e20 (inside a box) and 3e38 (outside every box): areas overflow to "
                "inf, and the CIoU stays a number",
    "chunk_ties": "every anchor inside one GT box aligns equally, over all three levels: the winners are the lowest "
                  "indices, across any split of the anchors into chunks",
    "pass_split": "1536 px (A = 48,384, past the candidates kernel's one pass of PASS_A = 48,128 anchors): a box "
                  "whose equally aligned anchors lie on both sides of the boundary, so its winners come from both "
                  "passes in index order; a box whose anchors lie past it; a NaN logit past it",
}
# On the card also the training step's shape, [32, 16, 8400] with 80 classes,
# and 2560 px (A = 134,400: three passes of the candidates kernel).
CARD_CASES = tuple(CASES) + ("step", "wide")
PASS_A = 8 * 6016  # anchors the candidates kernel stages in one pass (kernels/tal.py PASS_A)


def anchors(size: int, strides=(8, 16, 32)) -> np.ndarray:
    """Anchor centres in pixels, level by level ((x + 0.5, y + 0.5) * stride)."""
    pts = []
    for s in strides:
        n = size // s
        ys, xs = np.meshgrid(np.arange(n) + 0.5, np.arange(n) + 0.5, indexing="ij")
        pts.append(np.stack([xs, ys], -1).reshape(-1, 2) * s)
    return np.concatenate(pts).astype(np.float32)


def _base(rng, b: int, n: int, size: int = 64, strides=(8, 16, 32), nc: int = NC, wh=(4.0, 30.0)) -> dict:
    anc = anchors(size, strides)
    a = len(anc)
    lo, hi = rng.uniform(2, 20, (2, b, a, 2))
    pd = np.concatenate([anc - lo, anc + hi], -1).astype(np.float32)
    xy = rng.uniform(0, size - wh[0], (b, n, 2))
    gb = np.concatenate([xy, xy + rng.uniform(*wh, (b, n, 2))], -1).astype(np.float32)
    return dict(pd_scores=(rng.randn(b, a, nc) * 2).astype(np.float32), pd_bboxes=pd, anc=anc,
                gt_labels=rng.randint(0, nc, (b, n)).astype(np.int32), gt_bboxes=gb,
                mask_gt=rng.uniform(size=(b, n)) < 0.4, concat=False, spot=None)


def _index(anc: np.ndarray, x: float, y: float) -> int:
    return int(np.flatnonzero((anc[:, 0] == x) & (anc[:, 1] == y))[0])


def _inside(c: dict, img: int, slot: int) -> int:
    """The first anchor whose centre lies inside image `img`'s box `slot`."""
    box = c["gt_bboxes"][img, slot]
    return int(np.flatnonzero(((c["anc"] > box[:2] + 1e-3) & (c["anc"] < box[2:] - 1e-3)).all(-1))[0])


def _outside(c: dict, img: int) -> int:
    """The last anchor whose centre lies outside every box of image `img`."""
    lo, hi = c["gt_bboxes"][img, :, None, :2], c["gt_bboxes"][img, :, None, 2:]
    within = ((c["anc"][None] > lo) & (c["anc"][None] < hi)).all(-1).any(0)
    return int(np.flatnonzero(~within)[-1])


def _clear(c: dict, img: int, keep, lo: float, hi: float) -> None:
    """Move image `img`'s GT boxes other than `keep` out of [lo, hi]^2."""
    for j in range(c["gt_bboxes"].shape[1]):
        box = c["gt_bboxes"][img, j]
        if j not in keep and box[0] < hi and box[1] < hi and box[2] > lo and box[3] > lo:
            c["gt_bboxes"][img, j] += hi + 2 - min(box[0], box[1])


def tal_case(name: str, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    if name == "masked_wins":
        c = _base(rng, 2, 16)
        a = _index(c["anc"], 28.0, 28.0)
        c["mask_gt"][0, [2, 5]] = True
        c["mask_gt"][0, 9] = False
        c["gt_bboxes"][0, 2] = [20, 20, 40, 40]
        c["gt_bboxes"][0, 5] = [18, 22, 38, 42]
        c["pd_bboxes"][0, a] = [22, 22, 38, 40]
        c["gt_bboxes"][0, 9] = c["pd_bboxes"][0, a]  # CIoU 1 against the anchor's box
        for j in (2, 5):  # the anchor leads both rows: the other centres inside score low
            lab = c["gt_labels"][0, j]
            inside = ((c["anc"] > c["gt_bboxes"][0, j, :2]) & (c["anc"] < c["gt_bboxes"][0, j, 2:])).all(-1)
            c["pd_scores"][0, inside, lab] = -5.0
            c["pd_scores"][0, a, lab] = 5.0
        c["spot"] = dict(image=0, anchor=a, slot=9)
    elif name == "fallback":
        c = _base(rng, 2, 8)
        c["mask_gt"][0, [1, 3]] = True
        c["gt_bboxes"][0, 1] = [0.1, 0.1, 0.2, 0.2]  # no anchor centre inside
        c["gt_bboxes"][0, 3] = [0, 0, 10, 10]  # the centres of anchors 0 (4, 4) and 64 (8, 8)
        c["pd_bboxes"][0, [0, 64]] = [50, 50, 60, 60]  # CIoU clamps to 0: no align above eps
        _clear(c, 0, (1, 3), 0, 10)
        c["spot"] = dict(image=0, anchor=0, slot=3, empty=1)
    elif name == "few_positive":
        c = _base(rng, 2, 8)
        c["mask_gt"][0, 0] = True
        c["gt_bboxes"][0, 0] = [0, 0, 20, 20]  # centres of anchors 0, 1, 8, 9 (stride 8), 64, 80
        c["pd_bboxes"][0, [0, 1]] = [1, 1, 19, 19]
        c["pd_bboxes"][0, [8, 9, 64, 80]] = [50, 50, 60, 60]
        _clear(c, 0, (0,), 0, 24)
        c["spot"] = dict(image=0, anchor=8, slot=0)
    elif name == "twins":
        c = _base(rng, 2, 8)
        c["mask_gt"][0, [2, 4]] = True
        c["gt_bboxes"][0, [2, 4]] = [20, 20, 44, 44]
        c["gt_labels"][0, 4] = c["gt_labels"][0, 2]
        _clear(c, 0, (2, 4), 16, 48)
        c["spot"] = dict(image=0, slot=2, twin=4)
    elif name == "k_ge_a":
        c = _base(rng, 2, 4, size=32, strides=(16, 32), wh=(8.0, 24.0))
        c["mask_gt"][:, 0] = True
    elif name in ("n1", "n16", "n128"):
        n = int(name[1:])
        c = _base(rng, 3 if n < 128 else 2, n)
        c["mask_gt"][0, 0] = True
    elif name == "concat":
        c = _base(rng, 2, 8)
        reg = rng.randn(2, c["pd_scores"].shape[1], REG).astype(np.float32)
        c["pd_scores"] = np.concatenate([reg, c["pd_scores"]], -1)
        c["concat"] = True
    elif name == "all_masked":
        c = _base(rng, 3, 8)
        c["mask_gt"][1] = False
        c["mask_gt"][0, 0] = True
    elif name == "full_size":
        c = _base(rng, 2, 16, size=640, nc=80, wh=(8.0, 60.0))
    elif name == "nan_logit":
        c = _base(rng, 2, 8)
        c["mask_gt"][0, [1, 4]] = True
        a = _outside(c, 0)
        c["pd_scores"][0, a, c["gt_labels"][0, 1]] = np.nan
        c["spot"] = dict(image=0, anchor=a, slot=1)
    elif name == "inf_box":
        c = _base(rng, 2, 8)
        c["mask_gt"][0, 2] = True
        a = _outside(c, 0)
        c["pd_bboxes"][0, a, 2] = np.inf
        c["spot"] = dict(image=0, anchor=a, slot=2)
    elif name == "huge_box":
        c = _base(rng, 2, 8)
        c["mask_gt"][0, 3] = True
        out, inn = _outside(c, 0), _index(c["anc"], *c["anc"][_inside(c, 0, 3)])
        c["pd_bboxes"][0, out] = [-3e38, 0, 3e38, 1]  # its width, area and enclosing diagonal overflow to inf
        c["pd_bboxes"][0, inn] = [-1e20, -1e20, 1e20, 1e20]
        c["spot"] = dict(image=0, anchor=out, inside=inn, slot=3)
    elif name == "chunk_ties":
        c = _base(rng, 2, 8)
        c["mask_gt"][0, 0] = True
        c["gt_bboxes"][0, 0] = [2, 2, 62, 62]  # every anchor centre of the 64 px image
        c["pd_bboxes"][0] = [10, 10, 54, 54]
        c["pd_scores"][0, :, c["gt_labels"][0, 0]] = 1.5
        _clear(c, 0, (0,), 0, 64)
        c["spot"] = dict(image=0, slot=0)
    elif name == "pass_split":
        c = _base(rng, 2, 8, size=1536, wh=(8.0, 120.0))
        anc = c["anc"]
        # Image 0, slot 0: the stride-32 anchors of rows 41-43, columns 31-37
        # (centres x 1008-1200, y 1328-1392), 48,079-48,181, straddle the
        # boundary (48,127 before it, 48,128 after it). Each aligns 1: its
        # box is the GT's and its logit high. The box's other anchors
        # (strides 8 and 16, lower indices) align low.
        c["mask_gt"][0, [0, 1]] = True
        c["gt_bboxes"][0, 0] = [1000, 1320, 1200, 1400]
        _clear(c, 0, (0, 1), 900, 1500)
        inside = ((anc > c["gt_bboxes"][0, 0, :2]) & (anc < c["gt_bboxes"][0, 0, 2:])).all(-1)
        c["pd_scores"][0, inside, c["gt_labels"][0, 0]] = -6.0
        tied = inside & (np.arange(len(anc)) >= 46080)
        c["pd_bboxes"][0, tied] = c["gt_bboxes"][0, 0]
        c["pd_scores"][0, tied, c["gt_labels"][0, 0]] = 9.0
        # Slot 1: a box at the bottom right whose stride-32 anchors (all past
        # the boundary) lead, the others (strides 8 and 16) align low.
        c["gt_bboxes"][0, 1] = [1410, 1410, 1530, 1530]
        _clear(c, 0, (0, 1), 1400, 1536)
        inside = ((anc > c["gt_bboxes"][0, 1, :2]) & (anc < c["gt_bboxes"][0, 1, 2:])).all(-1)
        c["pd_scores"][0, inside, c["gt_labels"][0, 1]] = -6.0
        lead = inside & (np.arange(len(anc)) >= 46080)
        c["pd_bboxes"][0, lead] = [1412, 1412, 1528, 1528]
        c["pd_scores"][0, lead, c["gt_labels"][0, 1]] = 4.0
        # Image 1: a NaN logit at an anchor past the boundary, outside every box.
        c["mask_gt"][1, 0] = True
        a = _outside(c, 1)
        c["pd_scores"][1, a, c["gt_labels"][1, 0]] = np.nan
        c["spot"] = dict(image=0, slot=0, tied=np.flatnonzero(tied), nan_image=1, nan_anchor=a)
    elif name == "step":
        c = _base(rng, 32, 16, size=640, nc=80, wh=(8.0, 60.0))
    elif name == "wide":
        c = _base(rng, 2, 8, size=2560, wh=(8.0, 200.0))
    else:
        raise KeyError(name)
    return c


def scores_of(c: dict):
    """The class logits of a case as the assignment reads them (a view of the
    concatenated rows for "concat")."""
    return c["pd_scores"][..., REG:] if c["concat"] else c["pd_scores"]


def tensors(c: dict, device="cpu", rows=slice(None)) -> tuple:
    """The assignment's six inputs as torch tensors on `device`, images
    `rows` (pd_scores a strided view of the concatenated rows for "concat")."""
    import torch

    s = torch.from_numpy(c["pd_scores"][rows]).to(device)
    return (s[..., REG:] if c["concat"] else s, torch.from_numpy(c["pd_bboxes"][rows]).to(device),
            torch.from_numpy(c["anc"]).to(device),
            *(torch.from_numpy(c[k][rows]).to(device) for k in ("gt_labels", "gt_bboxes", "mask_gt")))
