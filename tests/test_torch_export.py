"""The serving export (leanyolo_tpu_torch/export/serving.py and
tools/export_serving.py) against the JAX package's, on the CPU.

`build_serving_fn` against JAX's jitted one on the same parameters and
pixels: fp32 scores within 5e-4 and boxes within 5e-4 of the image size,
`num` and classes exact, at every rank whose score stands more than 1e-4
from its neighbours' (elsewhere the two frameworks' fp32 noise may swap two
candidates). bf16: head maps within 4 bf16 ulps, and the decode on
identical maps as fp32's within 1e-4 (a random net's bf16 scores are
closer together than the maps' bf16 noise, so ranks are compared there). Ranking is on sigmoid scores: with
saturated scores (1.0 in both) the ranks tie and go to the lower index in
both packages. torch.sigmoid and jax.nn.sigmoid round fp32 alike above a
logit of 6.41 and up to 3 ulps apart below it (test_sigmoid_fp32_*); the
port ranks by its own scores, which is why the comparison skips near-ties.

The artifact round trip (`export_serving` -> `load_exported`) is bit-equal
to the live module: exported at batch 2 with a symbolic batch and run at 1
and 3, and exported at a static batch of 1 (the sidecar test, the CLI).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.export import serving as JS
from leanyolo_tpu_torch.export import serving as TS
from leanyolo_tpu_torch.kernels import LAUNCHES, reset_launches
from torch_parity import bf16_ulps, jax_and_port_models

SIZE = 64
NC = 8


@pytest.fixture(scope="module")
def models():
    return jax_and_port_models("yolov10n", NC, 3)


def _edit_cls_heads(jm, edit):
    """Both packages' models with `edit` applied to the JAX parameters of
    every final class conv ({'w', 'b'}) of both head branches."""
    from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.models.yolov10.convert import load_jax_params

    jp = jax.tree_util.tree_map(np.array, jm.params)  # a copy
    for branch in ("cv3", "one2one_cv3"):
        for level in jp["head"][branch]:
            edit(level["2"])
    jm2 = JYOLOv10(cfg=jm.cfg, class_names=jm.class_names, params=jp)
    return jm2, load_jax_params(YOLOv10.create(jm.cfg.name, class_names=jm.class_names), jp)


def _pixels(seed: int, b: int, size: int = SIZE) -> np.ndarray:
    return np.random.RandomState(seed).uniform(0, 255, (b, size, size, 3)).astype(np.float32)


def _decided(scores: np.ndarray, gap: float, runs: bool = False) -> np.ndarray:
    """[B, k] descending scores -> the ranks set apart from their neighbours
    by more than `gap`; with `runs`, a run of exactly equal scores counts as
    one rank (equal anchors, ranked by index in both packages)."""
    out = np.zeros(scores.shape, bool)
    for i, row in enumerate(scores):
        starts = np.flatnonzero(np.r_[True, row[1:] != row[:-1]]) if runs else np.arange(len(row))
        vals = row[starts]
        sep = np.minimum(np.abs(np.diff(vals, prepend=np.inf)), np.abs(np.diff(vals, append=-np.inf))) > gap
        for s0, s1, ok in zip(starts, np.r_[starts[1:], len(row)], sep):
            out[i, s0:s1] = ok
    return out


def _assert_close(got, ref, *, size: int, tol: float = 5e-4) -> int:
    """num equal; at the decided ranks classes equal, scores within tol and
    boxes within tol of the image size; returns the decided ranks' count."""
    (gd, gn), (rd, rn) = got, ref
    gd, gn, rd, rn = gd.numpy(), gn.numpy(), np.asarray(rd, np.float32), np.asarray(rn)
    assert gd.shape == rd.shape and gd.dtype == np.float32 and gn.dtype == np.int32
    np.testing.assert_array_equal(gn, rn)
    decided = _decided(rd[..., 4], 1e-4)
    np.testing.assert_array_equal(gd[..., 5][decided], rd[..., 5][decided])
    np.testing.assert_allclose(gd[..., 4][decided], rd[..., 4][decided], rtol=0, atol=tol)
    np.testing.assert_allclose(gd[..., :4][decided], rd[..., :4][decided], rtol=0, atol=tol * size)
    return int(decided.sum())


@pytest.mark.parametrize("decode", ["topk", "nms"])
def test_build_serving_fn_matches_jax_fp32(models, decode):
    jm, tm = models
    x = _pixels(0, 2)
    kw = dict(imgsz=SIZE, decode=decode, max_dets=100, conf=0.25, iou=0.45, pre_topk=300, dtype="float32")
    jfn, _ = JS.build_serving_fn(jm, **kw)
    ref = jax.jit(jfn)(jnp.asarray(x))
    tfn, params = TS.build_serving_fn(tm, device="cpu", **kw)
    assert "backbone.cv0.conv.weight" in params
    reset_launches()
    with torch.no_grad():
        got = tfn(torch.from_numpy(x))
    assert LAUNCHES["topk"] == 0  # the CPU takes the plain versions
    assert _assert_close(got, ref, size=SIZE) >= 20
    assert int(got[1].min()) > 0


@pytest.mark.parametrize("decode", ["topk", "nms"])
def test_build_serving_fn_matches_jax_bf16(models, decode, monkeypatch):
    """bf16: the head maps within 4 bf16 ulps of max(1, scale) of JAX's (as
    in test_torch_model.py); a random net's scores lie closer together than
    that, so the decode is held on identical maps: JAX's serving function
    fed the port's bf16 head maps gives the port's num and classes, scores
    within 3 fp32 ulps (the sigmoids') and boxes within 1e-4 of the image."""
    jm, tm = models
    x = _pixels(1, 2)
    kw = dict(imgsz=SIZE, decode=decode, max_dets=100, conf=0.25, iou=0.45, pre_topk=300, dtype="bf16")
    tfn, _ = TS.build_serving_fn(tm, device="cpu", **kw)
    branch = "one2many" if decode == "nms" else "one2one"
    with torch.no_grad():
        got = tfn(torch.from_numpy(x))
        maps = tfn.model(torch.from_numpy(x).bfloat16(), dtype=torch.bfloat16, branches=(branch,), normalize=False,
                         concat_head=False)[branch]
    maps = [torch.cat([r, c], -1).float().numpy() for r, c in maps]
    jfn, jparams = JS.build_serving_fn(jm, **kw)
    ref_maps = jax.jit(lambda p, im: JS.model_apply(p, im.astype(jnp.bfloat16), jm.cfg, train=False, branches=(branch,),
                                                    normalize=False)[branch])(jparams, jnp.asarray(x))
    for m, r in zip(maps, ref_maps):
        r = np.asarray(r, np.float32)
        assert np.abs(m - r).max() <= bf16_ulps(r, 4)
    monkeypatch.setattr(JS, "model_apply", lambda *a, **k: {branch: [jnp.asarray(m, jnp.bfloat16) for m in maps]})
    ref = jax.jit(jfn)(jnp.asarray(x))
    assert _assert_close(got, ref, size=SIZE, tol=1e-4) >= 10
def test_saturated_scores_rank_by_index(models):
    """Class 3's logits pushed past 16.6 at every anchor: fp32 sigmoid is
    1.0 there in both packages, the scores tie, and both rank the anchors
    in index order (a ranking of logits would not)."""
    def saturate(conv):
        conv["b"][3] = 40.0

    jm2, tm2 = _edit_cls_heads(models[0], saturate)
    x = _pixels(2, 2)
    kw = dict(imgsz=SIZE, decode="topk", max_dets=50, dtype="float32")  # 50 of the 84 anchors
    ref = jax.jit(JS.build_serving_fn(jm2, **kw)[0])(jnp.asarray(x))
    with torch.no_grad():
        got = TS.build_serving_fn(tm2, device="cpu", **kw)[0](torch.from_numpy(x))
    rd, gd = np.asarray(ref[0]), got[0].numpy()
    assert (rd[..., 4] == 1.0).all() and (gd[..., 4] == 1.0).all() and (gd[..., 5] == 3).all()
    np.testing.assert_allclose(gd[..., :4], rd[..., :4], rtol=0, atol=5e-4 * SIZE)  # the same anchors, in order
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_sigmoid_fp32_against_jax():
    """fp32 sigmoid: torch's and XLA's differ by at most 3 ulps, only below
    a logit of 6.41, and saturate to 1.0 at the same logit (16.6355)."""
    x = np.linspace(-80, 40, 1_200_001).astype(np.float32)
    ref = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    got = torch.sigmoid(torch.from_numpy(x)).numpy()
    ulps = np.abs(ref.view(np.int32) - got.view(np.int32))
    assert ulps.max() <= 3 and ulps.any()
    assert not ulps[x > 6.42].any()
    assert x[ref == 1.0].min() == x[got == 1.0].min()


def _live(fn, x):
    with torch.no_grad():
        return fn(torch.from_numpy(x))


def _bit_equal(a, b) -> bool:
    return torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)) and torch.equal(a[1], b[1])


def test_export_round_trip_symbolic_batch(models, tmp_path):
    """The NMS route exported at batch 2 (the top-k route's static export is
    the sidecar test's and the CLI's)."""
    _, tm = models
    kw = dict(imgsz=SIZE, decode="nms", max_dets=50, dtype="float32")
    path = TS.export_serving(tm, str(tmp_path / "art"), device="cpu", **kw)
    assert path.endswith(".pt2")
    fn = TS.load_exported(path)
    live, _ = TS.build_serving_fn(tm, device="cpu", **kw)
    for b in (1, 3):  # exported at 2
        x = _pixels(10 + b, b)
        got = _live(fn, x)
        assert got[0].shape == (b, 50, 6) and got[1].shape == (b,)
        assert _bit_equal(got, _live(live, x))
    text = open(path + ".json", encoding="utf-8").read()
    meta = json.loads(text)
    assert meta["format"] == "torch.export" and meta["torch_version"] == torch.__version__
    assert "leanyolo_tpu_torch.kernels" in meta["load"] and meta["dynamic_batch"] is True
    assert meta["outputs"] == {"detections": [None, 50, 6], "num_dets": [None]}


def test_sidecar_keys_are_jaxs(models, tmp_path):
    """The sidecar has every key of JAX's (`jax.export`'s sidecar, written at
    32 px with a static batch), with the same values where they mean the
    same, plus the torch version and how to load it."""
    jm, tm = models
    kw = dict(imgsz=32, decode="topk", max_dets=20, dynamic_batch=False)
    jpath = JS.export_serving(jm, str(tmp_path / "j"), **kw)
    tpath = TS.export_serving(tm, str(tmp_path / "t"), device="cpu", **kw)
    jmeta = json.load(open(jpath + ".json", encoding="utf-8"))
    tmeta = json.load(open(tpath + ".json", encoding="utf-8"))
    assert set(tmeta) == set(jmeta) | {"torch_version", "load"}
    for k in set(jmeta) - {"format", "leanyolo_version"}:
        assert tmeta[k] == jmeta[k], k
    x = _pixels(5, 1, 32)
    assert _bit_equal(_live(TS.load_exported(tpath), x), _live(TS.build_serving_fn(tm, device="cpu", imgsz=32,
                                                                                    max_dets=20)[0], x))


def test_bucketed_serving_matches_jax(models, tmp_path):
    """Mixed-size images through both packages' bucketed serving (the
    manifests' keys alike): the same bucket per image, the same letterbox,
    detections in original coordinates as in build_serving_fn's test, where
    runs of exactly equal scores (the letterbox's gray border gives equal
    anchors, ranked by index in both) count as one rank, and the sorted
    scores agree within 5e-4 at every rank."""
    jm, tm = models
    kw = dict(sizes=(32, 64), decode="topk", max_dets=40, conf=0.25)
    jman = JS.export_serving_bucketed(jm, str(tmp_path / "j"), **kw)
    tman = TS.export_serving_bucketed(tm, str(tmp_path / "t"), device="cpu", **kw)
    jmeta, tmeta = (json.load(open(p, encoding="utf-8")) for p in (jman, tman))
    assert set(tmeta) == set(jmeta) | {"torch_version", "load"}
    assert tmeta["policy"] == jmeta["policy"] and list(tmeta["buckets"]) == list(jmeta["buckets"])
    rs = np.random.RandomState(4)
    imgs = [rs.randint(0, 256, s, np.uint8) for s in ((20, 30, 3), (50, 40, 3), (200, 100, 3), (32, 32, 3))]
    ref = JS.BucketedServing(jman).predict_images(imgs, apply_conf_filter=False)
    got = TS.BucketedServing(tman).predict_images(imgs, apply_conf_filter=False)
    decided_rows = 0
    for g, r, img in zip(got, ref, imgs):
        assert g.shape == r.shape
        np.testing.assert_allclose(np.sort(g[:, 4]), np.sort(r[:, 4]), rtol=0, atol=5e-4)
        decided = _decided(r[None, :, 4], 1e-4, runs=True)[0]
        decided_rows += int(decided.sum())
        np.testing.assert_array_equal(g[decided, 5], r[decided, 5])
        np.testing.assert_allclose(g[decided, 4], r[decided, 4], rtol=0, atol=5e-4)
        np.testing.assert_allclose(g[decided, :4], r[decided, :4], rtol=0, atol=5e-4 * max(img.shape))
    assert decided_rows >= 5


@pytest.mark.parametrize("argv", [["--imgsz", "64", "--static-batch"],
                                  ["--sizes", "32,64", "--imgsz", "640"]], ids=["single", "bucketed"])
def test_export_cli_validate(tmp_path, capsys, argv):
    from leanyolo_tpu_torch.tools import export_serving as cli

    cli.main(["--model", "yolov10n", "--weights", "none", "--class-names", "a,b,c", "--decode", "nms",
              "--out", str(tmp_path / "out"), "--validate", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert "validation PASSED" in out and "dets bit-equal=True" in out and "dets bit-equal=False" not in out
    if "--sizes" in argv:
        assert "is NOT among the exported buckets" in out
        assert sorted(json.load(open(tmp_path / "out" / "manifest.json"))["buckets"]) == ["32", "64"]
    else:
        assert json.load(open(tmp_path / "out.pt2.json"))["dynamic_batch"] is False


def _op_cases():
    """([(operator name, CPU arguments)] at small shapes, {name: its plain
    version on those arguments})."""
    from leanyolo_tpu_torch.kernels import argmax, dwconv, matmul, nms, s2dconv, stem, topk

    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=g).to(dt)  # noqa: E731
    w0, b0, w1, b1 = r(16, 3, 3, 3), r(16), r(32, 16, 3, 3), r(32)
    imgs = torch.randint(0, 256, (2, 32, 32, 3), generator=g, dtype=torch.uint8)
    w49, bd = dwconv.pack_weights(r(8, 1, 7, 7)), r(8)
    ws, bs = s2dconv.pack_weights(r(32, 32, 3, 3)), r(32)
    xy = torch.rand(2, 40, 2, generator=g) * 50
    boxes = torch.cat([xy, xy + torch.rand(2, 40, 2, generator=g) * 20 + 1], -1)
    scores = torch.rand(2, 40, generator=g).sort(dim=1, descending=True).values
    cls = torch.randint(0, 4, (2, 40), generator=g).float()
    packed = stem.pack_weights(w0.bfloat16(), w1.bfloat16())
    return [
        ("fused_stem", (imgs, w0, b0, w1, b1, torch.float32, None, None)),
        ("fused_stem", (imgs, w0.bfloat16(), b0, w1.bfloat16(), b1, torch.bfloat16, *packed)),
        ("dw7x7_bias_silu", (r(2, 9, 11, 8), w49, bd)),
        ("conv3x3_c32_bias_silu", (r(2, 10, 7, 32, dt=torch.bfloat16), ws, bs, 0b11100100)),
        ("bmm", (r(2, 20, 16), r(16, 24), r(24), True)),
        ("bmm", (r(2, 20, 16, dt=torch.bfloat16), r(16, 24, dt=torch.bfloat16), None, False)),
        ("topk", (r(3, 50), 7, False)),
        ("topk", (r(3, 50, dt=torch.bfloat16), 7, True)),
        ("max_argmax_levels", ([r(2, 12, 5), r(2, 3, 5)], False)),
        ("nms_keep", (boxes, 0.45, scores > 0.3)),
        ("nms_keep", (boxes.bfloat16(), 0.451, None)),
        ("nms_compact", (boxes, scores, cls, 0.45, 0.25, 30, True, 81920.0)),
        ("nms_compact", (boxes.bfloat16(), scores.bfloat16(), cls.bfloat16(), 0.45, 0.25, 50, False, 0.0)),
    ], {
        "fused_stem": lambda a: stem.fused_stem_plain(*a[:5], dtype=a[5]),
        "dw7x7_bias_silu": lambda a: dwconv.dw7x7_bias_silu_plain(*a),
        "conv3x3_c32_bias_silu": lambda a: s2dconv.conv3x3_c32_bias_silu_plain(*a[:3], s2dconv._taps_of(a[3])),
        "bmm": lambda a: matmul.bmm_plain(*a),
        "topk": lambda a: topk.topk_plain(a[0], a[1], canon_zero=a[2]),
        "max_argmax_levels": lambda a: argmax.max_argmax_levels_plain(a[0], canon_zero=a[1]),
        "nms_keep": lambda a: nms.nms_keep_plain(*a),
        "nms_compact": lambda a: nms.nms_compact_plain(*a[:3], iou_thresh=a[3], conf_thresh=a[4], max_det=a[5],
                                                       class_wise=a[6], group_offset=a[7]),
    }


_CASES, _PLAIN = _op_cases()


def _to_meta(a):
    if torch.is_tensor(a):
        return a.to("meta")
    return [_to_meta(t) for t in a] if isinstance(a, list) else a


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("case", range(len(_CASES)), ids=[f"{c[0]}-{i}" for i, c in enumerate(_CASES)])
def test_kernel_operators(case):
    """Each kernel wrapper is the operator leanyolo_tpu_torch::<name>: on CPU
    tensors it is its plain version (bit-equal, outputs contiguous), its
    fake implementation gives the real outputs' shapes and dtypes without
    data (meta tensors), and torch.library.opcheck passes."""
    name, args = _CASES[case]
    op = getattr(torch.ops.leanyolo_tpu_torch, name).default
    got = _flat(op(*args))
    want = _flat(_PLAIN[name](args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)
    fake = _flat(op(*[_to_meta(a) for a in args]))
    assert [(f.shape, f.dtype) for f in fake] == [(g.shape, g.dtype) for g in got]
    assert all(f.device.type == "meta" for f in fake)
    if hasattr(torch.library, "opcheck"):
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor", "test_aot_dispatch_dynamic"))
