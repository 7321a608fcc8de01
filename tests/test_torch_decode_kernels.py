"""The decode's level gather (K2, kernels/gather.py, a plain version: on the
card the fused second top-k's key builder) and selected-anchor DFL box
decode (K3, kernels/dfl.py) against the JAX package on the CPU, where the
operators run the plain versions; the fused second top-k's, the box
decode's and the flagging max/argmax's operators; and the top-k decode's
signed-zero ranking on fp32 maps.

- `gather_rows_plain` is bit-exact against JAX's one-hot-dot
  `_gather_levels`, which writes -0.0 as +0.0 and copies every other value.
- `dfl_boxes` (NMS mode) against JAX's `_gather_levels(_boxes_per_level(...))`
  and `dfl_boxes_plain` (top-k mode, the fused second top-k's epilogue)
  against the same boxes of `take_along_axis(anchors, pair // nc)` with
  `sigmoid(logit)` and `pair % nc`: boxes within 5e-4 of the pixel scale
  (relative), as tests/test_torch_decode.py holds the whole decode; scores
  within 2.4e-7 (torch's and XLA's fp32 sigmoids are one ulp apart on a few
  inputs, tests/test_torch_decode_nms.py); classes exact.
- `decode_topk` on maps whose class logits hold exact zeros of both signs
  selects JAX's anchors and classes in JAX's order, fp32 and bf16.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10 import decode as JD
from leanyolo_tpu_torch.kernels import argmax, dfl, gather, topk
from leanyolo_tpu_torch.models.yolov10 import decode as TD

REG = 16
STRIDES = (8, 16, 32)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _maps(seed: int, b: int, size: int, nc: int, zeros: bool = True):
    """Per-level (reg, cls) NHWC fp32 numpy maps; coarse class logits with
    zeros of both signs."""
    rng = np.random.RandomState(seed)
    out = []
    for s in STRIDES:
        h = size // s
        reg = (rng.randn(b, h, h, 4 * REG) * 2).astype(np.float32)
        cls = (np.round(rng.randn(b, h, h, nc) * 2) / 2).astype(np.float32)
        if zeros:
            cls[rng.rand(*cls.shape) < 0.5 * (cls == 0)] = -0.0
        out.append((reg, cls))
    return out


def _levels(maps, dtype: str, concat: bool):
    """The same per-level [B, HW, C] (reg, cls) arrays for JAX and the port:
    whole maps, or slices of the concatenated [B, H, W, 4R+nc] map (strided
    rows, read in place)."""
    jd, td = DTYPES[dtype]
    jl, tl = [], []
    for reg, cls in maps:
        b, h, w, nc = cls.shape
        if concat:
            cat = np.concatenate([reg, cls], -1).reshape(b, h * w, -1)
            j, t = jnp.asarray(cat, jd), torch.from_numpy(cat).to(td)
            jl.append((j[..., : 4 * REG], j[..., 4 * REG:]))
            tl.append((t[..., : 4 * REG], t[..., 4 * REG:]))
        else:
            r, c = reg.reshape(b, h * w, -1), cls.reshape(b, h * w, nc)
            jl.append((jnp.asarray(r, jd), jnp.asarray(c, jd)))
            tl.append((torch.from_numpy(r).to(td), torch.from_numpy(c).to(td)))
    return jl, tl


def _bits(x) -> np.ndarray:
    x = np.asarray(x.float() if torch.is_tensor(x) and x.dtype == torch.bfloat16 else x)
    x = np.asarray(x, np.float32)
    return x.view(np.uint32)


def _index(rng, b: int, a: int, k: int) -> np.ndarray:
    """k distinct anchors a row, in random order."""
    return np.stack([rng.permutation(a)[:k] for _ in range(b)]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("nc", [80, 3])
@pytest.mark.parametrize("k", [1, 300, "A"])
def test_gather_rows_bit_exact_to_jax(dtype, concat, nc, k):
    maps = _maps(11 + nc, 2, 128, nc)
    jl, tl = _levels(maps, dtype, concat)
    a = sum(c.shape[1] for _, c in tl)
    k = a if k == "A" else k
    idx = _index(np.random.RandomState(k), 2, a, k)
    ref = JD._gather_levels([c for _, c in jl], jnp.asarray(idx))
    got = gather.gather_rows_plain([c for _, c in tl], torch.from_numpy(idx))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (2, k, nc) and got.is_contiguous()
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(ref.astype(jnp.float32))))
    # The rows hold -0.0 where the maps do; none comes out.
    src = gather.gather_levels_plain([c for _, c in tl], torch.from_numpy(idx)).float()
    assert k < 300 or bool(((src == 0) & torch.signbit(src)).any())
    assert not bool(torch.signbit(got.float()[got.float() == 0]).any())


def test_gather_rows_outside_the_levels_gives_zero_rows():
    """JAX's one-hot matches no anchor for an index past the levels."""
    maps = _maps(2, 2, 64, 5)
    jl, tl = _levels(maps, "float32", False)
    a = sum(c.shape[1] for _, c in tl)
    idx = np.asarray([[0, a, a - 1], [a + 7, 3, 1]], np.int32)
    ref = np.asarray(JD._gather_levels([c for _, c in jl], jnp.asarray(idx)))
    got = gather.gather_rows_plain([c for _, c in tl], torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert not got[0, 1].any() and not got[1, 0].any()


def _jax_boxes(jl, hw, idx):
    return np.asarray(JD._gather_levels(JD._boxes_per_level(jl, hw, STRIDES, REG), jnp.asarray(idx)), np.float32)


def _assert_boxes(got, ref, size):
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=5e-4 / size, atol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("concat", [False, True])
@pytest.mark.parametrize("k", [1, 300, 1000, "A"])
def test_dfl_boxes_nms_mode_matches_jax(dtype, concat, k):
    size = 256
    maps = _maps(5, 2, size, 80)
    jl, tl = _levels(maps, dtype, concat)
    hw = [(size // s, size // s) for s in STRIDES]
    a = sum(h * w for h, w in hw)
    k = a if k == "A" else k
    idx = _index(np.random.RandomState(k + 1), 2, a, k)
    got = dfl.dfl_boxes([r for r, _ in tl], hw, STRIDES, torch.from_numpy(idx))
    assert tuple(got.shape) == (2, k, 4) and got.is_contiguous()
    _assert_boxes(got.numpy(), _jax_boxes(jl, hw, idx), size)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 300, 1000, "A"])
def test_dfl_boxes_topk_mode_matches_jax(dtype, k):
    """The det rows of top-k mode: the box of anchor_idx[pair // nc], the
    sigmoid of the pair's logit and its class."""
    size, nc = 256, 80
    jd, td = DTYPES[dtype]
    maps = _maps(6, 2, size, nc)
    jl, tl = _levels(maps, dtype, True)
    hw = [(size // s, size // s) for s in STRIDES]
    a = sum(h * w for h, w in hw)
    k = a if k == "A" else k
    rng = np.random.RandomState(k + 2)
    anchors = _index(rng, 2, a, k)
    pairs = np.stack([rng.permutation(k * nc)[:k] for _ in range(2)]).astype(np.int32)
    logits = (rng.randn(2, k) * 4).astype(np.float32)
    got = dfl.dfl_boxes_plain([r for r, _ in tl], hw, STRIDES, torch.from_numpy(anchors),
                              pair_idx=torch.from_numpy(pairs), pair_logits=torch.from_numpy(logits).to(td),
                              num_classes=nc).numpy()
    assert got.shape == (2, k, 6)
    final = np.take_along_axis(anchors, pairs // nc, axis=1)
    _assert_boxes(got[..., :4], _jax_boxes(jl, hw, final), size)
    score = np.asarray(jax.nn.sigmoid(jnp.asarray(logits, jd).astype(jnp.float32)))
    np.testing.assert_allclose(got[..., 4], score, rtol=0, atol=2.4e-7)
    np.testing.assert_array_equal(got[..., 5], (pairs % nc).astype(np.float32))


def test_dfl_boxes_plain_takes_any_reg_max():
    """The plain version decodes reg_max 8 as JAX's dense decode does."""
    rng = np.random.RandomState(9)
    hw = [(4, 4), (2, 2)]
    regs = [rng.randn(1, h * w, 32).astype(np.float32) * 2 for h, w in hw]
    idx = np.asarray([[0, 5, 17, 19, 16]], np.int32)
    ref = np.asarray(JD._gather_levels(JD._boxes_per_level([(jnp.asarray(r), None) for r in regs], hw, (8, 16), 8),
                                       jnp.asarray(idx)))
    got = dfl.dfl_boxes_plain([torch.from_numpy(r) for r in regs], hw, (8.0, 16.0), torch.from_numpy(idx))
    _assert_boxes(got.numpy(), ref, 32)


def _decode_pair(maps, dtype: str, max_det: int):
    jl, tl = _levels(maps, dtype, False)
    hw = [(m[1].shape[1], m[1].shape[2]) for m in maps]
    jmaps = [(r.reshape(r.shape[0], h, w, -1), c.reshape(c.shape[0], h, w, -1)) for (r, c), (h, w) in zip(jl, hw)]
    tmaps = [(r.reshape(r.shape[0], h, w, -1), c.reshape(c.shape[0], h, w, -1)) for (r, c), (h, w) in zip(tl, hw)]
    nc = maps[0][1].shape[-1]
    ref = np.asarray(JD.decode_topk(jmaps, num_classes=nc, strides=STRIDES, max_det=max_det), np.float32)
    got = TD.decode_topk(tmaps, num_classes=nc, strides=STRIDES, max_det=max_det).numpy()
    return got, ref


def _assert_same_decode(got, ref, size):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 5], ref[..., 5])  # classes, in rank order
    np.testing.assert_allclose(got[..., 4], ref[..., 4], rtol=0, atol=5e-4)
    _assert_boxes(got[..., :4], ref[..., :4], size)
    assert np.max(np.abs(got[..., :4] - ref[..., :4])) < 1e-2  # the same anchors


def test_decode_topk_signed_zero_minimal_case():
    """64 px, one image, every class logit -5 but anchor 0 (P3, row 0,
    column 0): class 0 -0.0, class 1 +0.0, and anchor 1: class 0 +0.0. JAX's
    max of [-0.0, +0.0] is +0.0 and its one-hot gather writes -0.0 as +0.0,
    so max_det 2 gives anchor 0 class 0, then anchor 0 class 1 (torch.amax
    and torch.gather would rank anchor 1 first)."""
    rng = np.random.RandomState(0)
    maps = []
    for s in STRIDES:
        h = 64 // s
        cls = np.full((1, h, h, 80), -5.0, np.float32)
        maps.append(((rng.randn(1, h, h, 4 * REG) * 2).astype(np.float32), cls))
    maps[0][1][0, 0, 0, 0], maps[0][1][0, 0, 0, 1], maps[0][1][0, 0, 1, 0] = -0.0, 0.0, 0.0
    for max_det in (1, 2):
        got, ref = _decode_pair(maps, "float32", max_det)
        _assert_same_decode(got, ref, 64)
    np.testing.assert_array_equal(got[0, :, 5], [0.0, 1.0])
    np.testing.assert_array_equal(got[0, 0, :4], got[0, 1, :4])  # one anchor
    boxes = dfl.dfl_boxes_plain([torch.from_numpy(maps[0][0].reshape(1, 64, -1))], [(8, 8)], [8.0],
                                torch.zeros(1, 1, dtype=torch.int32))
    np.testing.assert_array_equal(got[0, 0, :4], boxes[0, 0].numpy())  # anchor 0's


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(12))
def test_decode_topk_signed_zero_sweep(dtype, seed):
    """Integer class logits at most 0 (many anchors' max is a zero), half of
    the zeros -0.0, two images at 128 px: JAX's anchors, classes and order
    at max_det 10 and 300 (300 < A = 336, both stages ranked)."""
    rng = np.random.RandomState(100 + seed)
    maps = []
    for s in STRIDES:
        h = 128 // s
        cls = np.minimum(np.round(rng.randn(2, h, h, 80) * 2 - 1.5), 0.0).astype(np.float32)
        cls[(cls == 0) & (rng.rand(*cls.shape) < 0.5)] = -0.0
        maps.append(((rng.randn(2, h, h, 4 * REG) * 2).astype(np.float32), cls))
    for max_det in (10, 300):
        got, ref = _decode_pair(maps, dtype, max_det)
        _assert_same_decode(got, ref, 128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_topk_k_equals_anchors_signed_zeros(dtype):
    """k == A (64 px, max_det 300 > 84 anchors): stage 1's top-k takes
    lax.top_k's route in bf16 too, where -0.0 ranks below +0.0."""
    rng = np.random.RandomState(7)
    maps = []
    for s in STRIDES:
        h = 64 // s
        cls = np.minimum(np.round(rng.randn(2, h, h, 80) * 2 - 1.5), 0.0).astype(np.float32)
        cls[(cls == 0) & (rng.rand(*cls.shape) < 0.5)] = -0.0
        maps.append(((rng.randn(2, h, h, 4 * REG) * 2).astype(np.float32), cls))
    got, ref = _decode_pair(maps, dtype, 300)
    assert got.shape == (2, 84, 6)
    _assert_same_decode(got, ref, 64)


def _meta(a):
    if torch.is_tensor(a):
        return a.to("meta")
    return [_meta(t) for t in a] if isinstance(a, list) else a


def _op_cases():
    g = torch.Generator().manual_seed(0)
    cat = torch.randn(2, 20, 64 + 7, generator=g)
    small = torch.randn(2, 6, 64 + 7, generator=g)
    idx = torch.randint(0, 26, (2, 9), generator=g, dtype=torch.int32)
    cls, reg = [cat[..., 64:], small[..., 64:]], [cat[..., :64], small[..., :64]]
    bcls, breg = [c.bfloat16() for c in cls], [r.bfloat16() for r in reg]
    flags = argmax.flags_plain(cls, reg)
    nan_cls = [c.clone() for c in cls]
    nan_cls[1][1, 2, 3] = float("inf")
    nan_flags = argmax.flags_plain(nan_cls, reg)
    bnan_cls = [c.bfloat16() for c in nan_cls]
    return [
        ("topk_decode", (cls, reg, [5, 3], [8.0, 16.0], idx, 9, False, flags)),
        ("topk_decode", (bnan_cls, breg, [5, 3], [8.0, 16.0], idx, 40, True, argmax.flags_plain(bnan_cls, breg))),
        ("dfl_boxes", (reg, [5, 3], [8.0, 16.0], idx, None)),
        ("dfl_boxes", (breg, [5, 3], [8.0, 16.0], idx, nan_flags)),
        ("max_argmax_flags", (nan_cls, reg, False)),
        ("max_argmax_flags", (bcls, breg, True)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_decode_kernel_operators(case):
    """Each wrapper is the operator leanyolo_tpu_torch::<name>: on CPU
    tensors its plain version (bit-equal, contiguous output); its fake
    implementation gives the outputs' shape and dtype on meta tensors; and
    torch.library.opcheck passes (as tests/test_torch_export.py holds the
    other operators)."""
    name, args = _op_cases()[case]
    op = getattr(torch.ops.leanyolo_tpu_torch, name).default
    got = op(*args)
    if name == "max_argmax_flags":
        want = (*argmax.max_argmax_levels_plain(args[0], canon_zero=args[2]), argmax.flags_plain(args[0], args[1]))
    elif name == "topk_decode":  # the operator takes each level's width, the plain version its (h, w)
        cls, reg, widths, strides, idx, k, canon, flags = args
        hw = [(x.shape[1] // w, w) for x, w in zip(reg, widths)]
        want = topk.topk_decode_plain(cls, reg, hw, strides, idx, k, canon_zero=canon, flags=flags)
    else:
        levels, widths, strides, idx, flags = args
        want = dfl.dfl_boxes_plain(levels, [(x.shape[1] // w, w) for x, w in zip(levels, widths)], strides, idx,
                                   flags=flags)
    for g_, w_ in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g_.dtype == w_.dtype and g_.shape == w_.shape and g_.is_contiguous()
        assert torch.equal(g_.view(torch.int16 if g_.element_size() == 2 else torch.int32),
                           w_.view(torch.int16 if w_.element_size() == 2 else torch.int32))  # NaNs' bits too
    fake = op(*[_meta(a) for a in args])
    for f_, g_ in zip(fake if isinstance(fake, tuple) else (fake,), got if isinstance(got, tuple) else (got,)):
        assert f_.device.type == "meta" and (f_.shape, f_.dtype) == (g_.shape, g_.dtype)
    if hasattr(torch.library, "opcheck"):
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor", "test_aot_dispatch_dynamic"))


def test_decode_topk_runs_through_the_decode_operators(monkeypatch):
    """decode_topk's kernels: one max/argmax (with the flags), one top-k and
    one fused second top-k call (counted at the wrappers; on the CPU they run
    the plain versions); decode_nms one max/argmax, one top-k and one
    dfl_boxes."""
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    for mod, name in ((argmax, "max_argmax_flags"), (argmax, "max_argmax_levels"), (topk, "topk"),
                      (topk, "topk_decode"), (dfl, "dfl_boxes")):
        spy(mod, name)
    maps = [tuple(torch.from_numpy(t) for t in m) for m in _maps(3, 1, 64, 80)]
    TD.decode_topk(maps, num_classes=80)
    assert calls == {"max_argmax_flags": 1, "topk": 1, "topk_decode": 1}
    calls.clear()
    TD.decode_nms(maps, num_classes=80)
    assert calls == {"max_argmax_flags": 1, "topk": 1, "dfl_boxes": 1}


# (mode, elt, k): bytes and operations worked out by hand. NMS mode: each
# row's 64 bins, its int32 anchor and 4 fp32 out, with flags an image's four
# int32 side words; 97 fp32 operations a side (bounds.DFL_SIDE_OPS). The
# fused second top-k ("topk", k1 = k = 300, nc = 80): the int32 anchor and
# its 80 class logits a stage-1 row, an image's 3 * 80 + 4 int32 flags, then
# a winner's 64 bins and 6 fp32 out; a key a pair, 4 * 97 + 3 a winner.
_K3_WORK = [
    ("nms", 2, 1000, 32 * 1000 * (64 * 2 + 4 + 16), 32 * 1000 * 4 * 97),
    ("nms", 4, 1000, 32 * 1000 * (64 * 4 + 4 + 16), 32 * 1000 * 4 * 97),
    ("nms_flags", 2, 1000, 32 * 1000 * (64 * 2 + 4 + 16) + 32 * 16, 32 * 1000 * 4 * 97),
    ("topk", 2, 300, 32 * 300 * (4 + 80 * 2) + 32 * 244 * 4 + 32 * 300 * (64 * 2 + 24),
     32 * 300 * 80 + 32 * 300 * (4 * 97 + 3)),
    ("topk", 4, 300, 32 * 300 * (4 + 80 * 4) + 32 * 244 * 4 + 32 * 300 * (64 * 4 + 24),
     32 * 300 * 80 + 32 * 300 * (4 * 97 + 3)),
]


@pytest.mark.parametrize("case", range(len(_K3_WORK)))
def test_dfl_boxes_work_counts_each_byte_once(case):
    """K3's bound and the fused second top-k's count each index a row reads
    once: the fused op at [32, 300] x 80 bf16, k = 300, 3,064,832 bytes,
    0.000915 ms over 3.35 TB/s."""
    from leanyolo_tpu_torch.kernels import bounds

    mode, elt, k, nbytes, nops = _K3_WORK[case]
    if mode == "topk":
        assert bounds.topk_decode_work(32, k, 80, k, elt) == (nbytes, nops)
    else:
        assert bounds.dfl_boxes_work(32, k, elt, flags=mode == "nms_flags") == (nbytes, nops)
    if (mode, elt) == ("topk", 2):
        ms, by = bounds.bound(nbytes, nops, bounds.FP32_OPS_PER_S)
        assert nbytes == 3_064_832 and by == "bytes" and round(ms, 6) == 0.000915


def test_argmax_flags_work_counts_each_byte_once():
    """The flagging max/argmax's bound: the class maps and values, indices
    out as `argmax_work`, plus the reg maps read and the flags written."""
    from leanyolo_tpu_torch.kernels import bounds

    base, _ = bounds.argmax_work(32 * 8400, 80)
    assert bounds.argmax_flags_work(32, 8400, 80) == (base + 32 * 8400 * 64 * 2 + 32 * 244 * 4,
                                                      32 * 8400 * (160 + 128))


@pytest.mark.parametrize("decode", ["topk", "nms"])
def test_profile_step_decode_mode(tmp_path, capsys, decode):
    """`profile_step --mode decode` profiles the decode alone, on the head
    maps of one forward: no convolution in its table, the decode's operators
    in it (on the CPU: the plain versions' operators)."""
    import json

    from leanyolo_tpu_torch.tools import profile_step

    js = tmp_path / "p.json"
    profile_step.main(["--model", "yolov10n", "--weights", "none", "--mode", "decode", "--decode", decode,
                       "--imgsz", "64", "--batch-size", "2", "--dtype", "float32", "--fuse", "--steps", "2",
                       "--out-dir", str(tmp_path / "trace"), "--json", str(js), "--device", "cpu", "--top", "80"])
    names = {f["name"] for f in json.loads(js.read_text())["families"]}
    assert not any("conv" in n for n in names), names
    assert {"gather", "exp", "sigmoid"} <= names
    assert "on-device kernel time" not in capsys.readouterr().out
