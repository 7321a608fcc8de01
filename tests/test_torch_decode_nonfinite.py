"""The port's decodes against the JAX package on head maps that hold a
non-finite value, on the CPU.

JAX gathers the selected rows by a one-hot dot (`decode.py:102
_gather_levels`): each gathered element is a sum over every anchor of
`onehot * x`, so one non-finite value in a column (0 * inf = NaN) makes that
column NaN in every gathered row but its own anchor's, and a box side whose
dense DFL is NaN (a NaN or +inf bin, or all 16 bins -inf) makes that side
NaN in every gathered box. The port reproduces it from per-image flags
(kernels/argmax.py, kernels/gather.py, kernels/dfl.py). What the NaNs then
do to the ranking (a NaN's sign decides its place in lax.top_k's total
order) and to NMS is whatever JAX does.

Cases: +inf, -inf and NaN in one class logit or one reg bin of image 1, at
the anchor the finite decode ranks first (selected) and at the one it ranks
last (not selected), fp32 and bf16 maps, per level and as a concatenated
[B, H, W, 4R+nc] map, `decode_topk` and `decode_nms` with and without
`multi_label`. Image 0 stays finite. The selection is bit-exact: counts,
classes and the rows' order (boxes name the anchors); NaN at the same
positions; finite boxes within 5e-4 of the pixel scale and scores within
2.4e-7, as tests/test_torch_decode_kernels.py holds them.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10 import decode as JD
from leanyolo_tpu_torch.models.yolov10 import decode as TD

NC, REG, SIZE, B = 8, 16, 64, 2
STRIDES = (8, 16, 32)
MAX_DET, PRE_TOPK = 20, 30
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
VALUES = {"+inf": np.inf, "-inf": -np.inf, "nan": np.nan}
DECODES = ("topk", "nms", "nms_multi_label")


def _maps(seed: int = 3):
    """Per-level (reg, cls) NHWC fp32 numpy maps, scores spread around conf 0.25."""
    rng = np.random.RandomState(seed)
    out = []
    for s in STRIDES:
        h = SIZE // s
        reg = (rng.randn(B, h, h, 4 * REG) * 2).astype(np.float32)
        cls = (rng.randn(B, h, h, NC) * 2 - 1).astype(np.float32)
        out.append((reg, cls))
    return out


def _flat_cls(maps) -> np.ndarray:
    return np.concatenate([c.reshape(B, -1, NC) for _, c in maps], axis=1)  # [B, A, nc]


def _poke(maps, anchor: int, place: str, value: float, col: int):
    """A copy of the maps with `value` at image 1's global anchor `anchor`:
    class logit `col`, or reg bin 5 of side `col`; value "-inf16": all 16
    bins of the side."""
    maps = [(r.copy(), c.copy()) for r, c in maps]
    off = 0
    for reg, cls in maps:
        h, w = cls.shape[1:3]
        if off <= anchor < off + h * w:
            y, x = divmod(anchor - off, w)
            if place == "cls":
                cls[1, y, x, col] = value
            elif value == "-inf16":
                reg[1, y, x, col * REG:(col + 1) * REG] = -np.inf
            else:
                reg[1, y, x, col * REG + 5] = value
        off += h * w
    return maps


def _torch(j) -> torch.Tensor:
    """The port's tensor with the bits of JAX's array (torch rounds an fp32
    NaN to the bf16 NaN 0xFFFF, JAX to 0x7FC0)."""
    a = np.asarray(j)
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def _inputs(maps, dtype: str, concat: bool):
    jd = DTYPES[dtype][0]
    if concat:
        jmaps = [jnp.asarray(np.concatenate([r, c], -1), jd) for r, c in maps]
        return jmaps, [_torch(m) for m in jmaps]
    jmaps = [(jnp.asarray(r, jd), jnp.asarray(c, jd)) for r, c in maps]
    return jmaps, [(_torch(r), _torch(c)) for r, c in jmaps]


def _run(decode: str, jmaps, tmaps):
    """(port, JAX): (dets [B, k, 6] fp32, num [B] or None) as numpy."""
    if decode == "topk":
        ref = JD.decode_topk(jmaps, num_classes=NC, strides=STRIDES, max_det=MAX_DET)
        got = TD.decode_topk(tmaps, num_classes=NC, strides=STRIDES, max_det=MAX_DET)
        return (got.numpy(), None), (np.asarray(ref, np.float32), None)
    kw = dict(num_classes=NC, strides=STRIDES, conf_thresh=0.25, iou_thresh=0.45, max_det=MAX_DET,
              pre_topk=PRE_TOPK, multi_label=decode == "nms_multi_label")
    rd, rn = JD.decode_nms(jmaps, **kw)
    gd, gn = TD.decode_nms(tmaps, **kw)
    return (gd.numpy(), gn.numpy()), (np.asarray(rd, np.float32), np.asarray(rn))


def _assert_same(got, ref):
    (gd, gn), (rd, rn) = got, ref
    assert gd.shape == rd.shape and gd.dtype == np.float32
    if rn is not None:
        assert gn.dtype == np.int32
        np.testing.assert_array_equal(gn, rn)
    np.testing.assert_array_equal(gd[..., 5], rd[..., 5])  # classes, in rank order
    np.testing.assert_array_equal(np.isnan(gd), np.isnan(rd))  # NaN at the same places
    fin = ~np.isnan(rd)
    np.testing.assert_array_equal(gd[fin] == np.inf, rd[fin] == np.inf)
    np.testing.assert_allclose(gd[..., 4][fin[..., 4]], rd[..., 4][fin[..., 4]], rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(gd[..., :4][fin[..., :4]], rd[..., :4][fin[..., :4]], rtol=5e-4 / SIZE, atol=5e-4)


def _target(maps, selected: bool):
    """Image 1's anchor the finite maps rank first (or last) and its best class."""
    best = _flat_cls(maps)[1].max(axis=-1)
    anchor = int(np.argmax(best) if selected else np.argmin(best))
    return anchor, int(np.argmax(_flat_cls(maps)[1, anchor]))


@pytest.mark.parametrize("decode", DECODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("place", ["cls", "reg"])
@pytest.mark.parametrize("selected", [True, False])
@pytest.mark.parametrize("value", list(VALUES))
def test_nonfinite_decode_matches_jax(decode, dtype, concat, place, selected, value):
    maps = _maps()
    anchor, cls = _target(maps, selected)
    poked = _poke(maps, anchor, place, VALUES[value], cls if place == "cls" else 2)
    got, ref = _run(decode, *_inputs(poked, dtype, concat))
    _assert_same(got, ref)
    # Image 0 is finite and unchanged by image 1's value.
    fin, fin_ref = _run(decode, *_inputs(maps, dtype, concat))
    np.testing.assert_array_equal(got[0][0], fin[0][0])
    if place == "reg" and value != "-inf":  # the side's dense DFL is NaN: JAX's dot spreads it
        assert np.isnan(ref[0][1, :, 2]).all() and not np.isnan(ref[0][1, :, [0, 1, 3]]).any()


@pytest.mark.parametrize("decode", DECODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("selected", [True, False])
def test_all_bins_minus_inf_decode_matches_jax(decode, dtype, selected):
    """A side whose 16 bins are all -inf: the softmax's max is -inf, every
    bin -inf - -inf = NaN."""
    maps = _maps(5)
    anchor, _ = _target(maps, selected)
    poked = _poke(maps, anchor, "reg", "-inf16", 1)
    got, ref = _run(decode, *_inputs(poked, dtype, False))
    _assert_same(got, ref)
    assert np.isnan(ref[0][1, :, 1]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_nonfinite_values_in_a_column_match_jax(dtype):
    """+inf at the top anchor and at another in the same class column: the
    top anchor's own row is no longer its value but NaN, as every other
    row's."""
    maps = _maps(7)
    anchor, cls = _target(maps, True)
    poked = _poke(_poke(maps, anchor, "cls", np.inf, cls), (anchor + 9) % 84, "cls", np.inf, cls)
    for decode in DECODES:
        got, ref = _run(decode, *_inputs(poked, dtype, False))
        _assert_same(got, ref)
