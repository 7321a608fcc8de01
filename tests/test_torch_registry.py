"""The port's registry and checkpoints against the JAX package's:
`get_model` in its three weights modes, `list_models`, `get_model_weights`,
native `.npz` and lean `.pt` checkpoints going both ways between the
packages, strict refusals, the transfer load, and the whole slice on the
CPU: an official-format file -> `get_model` -> `Predictor` against the same
file through JAX's `get_model` and `Predictor`.

Official-format files are made from seeded JAX parameters
(test_torch_weights.py) and served from a local HTTP server at 127.0.0.1
or a `LEANYOLO_WEIGHTS_DIR`; nothing is downloaded from outside.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import leanyolo_tpu
import leanyolo_tpu_torch
from leanyolo_tpu import get_model as jget_model
from leanyolo_tpu.engine.predictor import Predictor as JPredictor
from leanyolo_tpu.models import registry as jregistry
from leanyolo_tpu.models.yolov10.config import VARIANTS as JVARIANTS
from leanyolo_tpu.models.yolov10.fold import fold_params
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10, model_apply
from leanyolo_tpu.models.yolov10.remap import params_to_torch_sd as jparams_to_torch_sd
from leanyolo_tpu.utils.weights import WeightsEntry as JWeightsEntry
from leanyolo_tpu_torch import Predictor, YOLOv10, get_model, get_model_weights, list_models
from leanyolo_tpu_torch.models import registry
from leanyolo_tpu_torch.models.yolov10.convert import export_jax_params, load_jax_params
from leanyolo_tpu_torch.models.yolov10.remap import params_to_torch_sd
from leanyolo_tpu_torch.utils.weights import WeightsEntry
from test_torch_weights import (  # noqa: F401  (http_server is a fixture)
    NAMES80,
    assert_state_equals_jax,
    emit_official_ckpt,
    fuse_repvggdw_keys,
    http_server,
    jax_params,
    official_sd,
)
from torch_parity import as_f32


def _jax_model(name: str) -> JYOLOv10:
    """A JAX model with the seeded randomized-BN parameters."""
    return JYOLOv10(cfg=JVARIANTS[name], class_names=list(NAMES80), params=jax_params(name))


def _load_recorded(fn, *a, **kw):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn(*a, **kw)
    return out, [str(x.message) for x in w]


def _pretrained_or_fail(fn, name):
    """get_model(PRETRAINED_COCO) that counts the random-init fallback, a
    missing leaf or less than full coverage as a failure; returns the model
    and the coverage message."""
    model, msgs = _load_recorded(fn, name, weights="PRETRAINED_COCO", class_names=NAMES80)
    assert not any("Proceeding with randomly initialized" in m for m in msgs), msgs
    assert not any("Missing leaves" in m for m in msgs), msgs
    cover = [m for m in msgs if "filled model:" in m]
    assert len(cover) == 1 and cover[0].endswith("leaves (100.0%)."), msgs
    return model, cover[0]


# ---------------------------------------------------------------------------
# The public API
# ---------------------------------------------------------------------------


def test_public_api_and_version():
    for name in ("get_model", "get_model_weights", "list_models", "__version__"):
        assert name in leanyolo_tpu_torch.__all__ and hasattr(leanyolo_tpu_torch, name)
    assert leanyolo_tpu_torch.__version__ == leanyolo_tpu.__version__
    assert tuple(list_models()) == tuple(leanyolo_tpu.list_models())


def test_weights_table_equals_jax():
    """The URL and SHA-256 table is JAX's, byte for byte."""
    assert registry._YOLOv10Weights._SHA == jregistry._YOLOv10Weights._SHA
    jtable = jregistry._YOLOv10Weights.MODEL_TO_WEIGHTS
    table = registry._YOLOv10Weights.MODEL_TO_WEIGHTS
    assert list(table) == list(jtable)
    for name in jtable:
        assert list(table[name]) == list(jtable[name]) == ["PRETRAINED_COCO"]
        e, je = table[name]["PRETRAINED_COCO"], jtable[name]["PRETRAINED_COCO"]
        for field in ("name", "url", "filename", "sha256", "metadata"):
            assert getattr(e, field) == getattr(je, field), (name, field)
        assert list(get_model_weights(name)().list(name)) == ["PRETRAINED_COCO"]


def test_registry_api_errors():
    with pytest.raises(ValueError, match="Unknown model"):
        get_model("yolov9", weights=None, class_names=["a"])
    with pytest.raises(ValueError, match="Unknown model"):
        get_model_weights("nope")
    with pytest.raises(ValueError, match="length 1 or 3"):
        get_model("yolov10n", weights=None, class_names=["a"], input_norm_divide=[1.0, 2.0])
    with pytest.raises(ValueError, match="'PRETRAINED_COCO', or None"):
        get_model("yolov10n", weights="NOT_A_FILE", class_names=["a"])
    resolver = get_model_weights("yolov10s")()
    entry = resolver.get("yolov10s", "PRETRAINED_COCO")
    assert entry.sha256 and entry.url.endswith("yolov10s.pt")
    with pytest.raises(KeyError):
        resolver.get("yolov10s", "NOPE")


def test_get_model_random_init_on_the_cpu():
    m = get_model("yolov10n", weights=None, class_names=["a", "b"], input_norm_subtract=[1.0],
                  input_norm_divide=[2.0, 3.0, 4.0], seed=5)
    assert isinstance(m, YOLOv10) and m.nc == 2 and m.class_names == ["a", "b"]
    assert all(t.device.type == "cpu" for t in m.state_dict().values())
    assert m.input_subtract.tolist() == [1.0] * 3 and m.input_divide.tolist() == [2.0, 3.0, 4.0]
    again = get_model("yolov10n", weights=None, class_names=["a", "b"], seed=5).state_dict()
    other = get_model("yolov10n", weights=None, class_names=["a", "b"], seed=6).state_dict()
    key = "backbone.cv0.conv.weight"
    assert torch.equal(m.state_dict()[key], again[key]) and not torch.equal(again[key], other[key])


# ---------------------------------------------------------------------------
# PRETRAINED_COCO
# ---------------------------------------------------------------------------


def _patch_entries(monkeypatch, tmp_path, name, url, sha):
    """Point both packages' PRETRAINED_COCO entry for `name` at `url`."""
    for reg, entry_cls in ((registry, WeightsEntry), (jregistry, JWeightsEntry)):
        monkeypatch.setitem(reg._YOLOv10Weights.MODEL_TO_WEIGHTS[name], "PRETRAINED_COCO",
                            entry_cls(name=f"{name}.PRETRAINED_COCO", url=url, filename=f"{name}.pt", sha256=sha))
    monkeypatch.setenv("LEANYOLO_CACHE_DIR", str(tmp_path / "wcache"))
    monkeypatch.delenv("LEANYOLO_WEIGHTS_DIR", raising=False)


@pytest.mark.parametrize("name,fused", [("yolov10n", False), ("yolov10s", True)])
def test_get_model_pretrained_over_http(name, fused, http_server, tmp_path, monkeypatch):
    """Download, hash check, stub unpickle, remap: full coverage, and the
    state and coverage report equal to JAX's get_model on the same file."""
    sd = official_sd(jax_params(name))
    if fused:
        sd, n = fuse_repvggdw_keys(sd)
        assert n > 0
    serve_dir, url = http_server
    sha = emit_official_ckpt(sd, serve_dir / f"{name}.pt")
    _patch_entries(monkeypatch, tmp_path, name, f"{url}/{name}.pt", sha)
    model, cover = _pretrained_or_fail(get_model, name)
    assert (tmp_path / "wcache" / f"{name}.pt").exists()
    jm, jcover = _pretrained_or_fail(jget_model, name)
    assert cover == jcover
    assert_state_equals_jax(model, jm.params)


def test_get_model_pretrained_from_weights_dir_fp16(tmp_path, monkeypatch):
    """A release-dtype (fp16) file in LEANYOLO_WEIGHTS_DIR, under the real
    table's entry: taken without a hash check, upcast exactly."""
    sd = official_sd(jax_params("yolov10n"), torch.float16)
    emit_official_ckpt(sd, tmp_path / "yolov10n.pt")
    monkeypatch.setenv("LEANYOLO_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("LEANYOLO_CACHE_DIR", str(tmp_path / "unused_cache"))
    model, _ = _pretrained_or_fail(get_model, "yolov10n")
    jm, _ = _pretrained_or_fail(jget_model, "yolov10n")
    assert_state_equals_jax(model, jm.params)
    assert torch.equal(model.backbone.cv0.conv.weight, sd["model.0.conv.weight"].float())
    assert not (tmp_path / "unused_cache").exists()


def test_get_model_pretrained_failure_keeps_random_init(http_server, tmp_path, monkeypatch):
    _, url = http_server
    _patch_entries(monkeypatch, tmp_path, "yolov10n", f"{url}/absent.pt", "0" * 64)
    model, msgs = _load_recorded(get_model, "yolov10n", weights="PRETRAINED_COCO", class_names=NAMES80, seed=2)
    assert any("Proceeding with randomly initialized weights" in m for m in msgs), msgs
    fresh = get_model("yolov10n", weights=None, class_names=NAMES80, seed=2).state_dict()
    assert all(torch.equal(t, fresh[k]) for k, t in model.state_dict().items())


# ---------------------------------------------------------------------------
# Native .npz and lean .pt files, both ways
# ---------------------------------------------------------------------------


def _write(fmt, writer, path, jm, tm):
    """Write jm (writer 'jax') or tm (writer 'port') as a `.npz` checkpoint
    (each package's save_checkpoint) or a lean `.pt` (its params_to_torch_sd)."""
    if fmt == "npz":
        if writer == "jax":
            jregistry.save_checkpoint(jm, path, extra_meta={"epoch": 3})
        else:
            registry.save_checkpoint(tm, path, extra_meta={"epoch": 3})
        return
    sd = ({k: torch.from_numpy(np.array(v)) for k, v in jparams_to_torch_sd(jm.params).items()} if writer == "jax"
          else params_to_torch_sd(tm))
    torch.save({"model": {"state_dict": sd}, "epoch": 3}, path)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_checkpoint_files_between_packages(fmt, writer, tmp_path):
    jm = _jax_model("yolov10n")
    tm = load_jax_params(YOLOv10.create("yolov10n", class_names=NAMES80), jm.params)
    path = str(tmp_path / f"ckpt.{fmt}")
    _write(fmt, writer, path, jm, tm)
    # The port reads it, through get_model(weights=<file>) ...
    got = get_model("yolov10n", weights=path, class_names=NAMES80, seed=1)
    assert_state_equals_jax(got, jm.params)
    # ... and so does JAX.
    other = JYOLOv10.create("yolov10n", class_names=NAMES80, seed=1)
    jregistry.load_checkpoint_into(other, path)
    assert_state_equals_jax(got, other.params)
    if fmt == "npz":
        meta = registry.load_checkpoint_meta(path)
        assert meta == jregistry.load_checkpoint_meta(path)
        assert meta["model_name"] == "yolov10n" and meta["class_names"] == NAMES80 and meta["epoch"] == 3
        assert meta["input_norm_divide"] == [255.0] * 3 and meta["leanyolo_version"] == "0.1"


def _bad_file(fmt, fault, tmp_path):
    jm = _jax_model("yolov10n")
    if fmt == "npz":
        path = str(tmp_path / "good.npz")
        jregistry.save_checkpoint(jm, path)
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
    else:
        flat = {k: torch.from_numpy(np.array(v)) for k, v in jparams_to_torch_sd(jm.params).items()}
    if fault == "missing":
        del flat["neck.p3_down.bn.bias"]
    elif fault == "unexpected":
        flat["extra.weight"] = flat["neck.p3_down.bn.bias"]
    else:
        flat["neck.p3_down.bn.bias"] = flat["neck.p3_down.bn.bias"][:5]
    path = str(tmp_path / f"bad.{fmt}")
    if fmt == "npz":
        np.savez(path, **flat)
    else:
        torch.save(flat, path)
    return path


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_strict_load_refuses_what_jax_refuses(fmt, fault, tmp_path):
    """Missing, unexpected and shape-mismatched keys: both packages raise,
    and the port's model is left as it was."""
    path = _bad_file(fmt, fault, tmp_path)
    with pytest.raises(ValueError):
        jregistry.load_checkpoint_into(JYOLOv10.create("yolov10n", class_names=NAMES80), path)
    tm = YOLOv10.create("yolov10n", class_names=NAMES80)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    with pytest.raises(ValueError):
        registry.load_checkpoint_into(tm, path)
    assert all(torch.equal(t, before[k]) for k, t in tm.state_dict().items())
    with pytest.raises(ValueError, match="Failed to load local weights"):
        get_model("yolov10n", weights=path, class_names=NAMES80)


def test_transfer_load_matches_jax(tmp_path):
    """An 80-class file into a 7-class model: the same loaded, skipped,
    missing and unused keys as JAX; loaded leaves carry the file's values,
    skipped ones the fresh init."""
    path = str(tmp_path / "coco.npz")
    jregistry.save_checkpoint(_jax_model("yolov10n"), path)
    names7 = [f"k{i}" for i in range(7)]
    jdst = JYOLOv10.create("yolov10n", class_names=names7, seed=4)
    tdst = load_jax_params(YOLOv10.create("yolov10n", class_names=names7), jdst.params)
    with pytest.warns(RuntimeWarning, match="Transfer load"):
        jstats = jregistry.load_checkpoint_transfer(jdst, path)
    with pytest.warns(RuntimeWarning, match="Transfer load"):
        stats = registry.load_checkpoint_transfer(tdst, path)
    assert stats == jstats
    # The class branches' widths follow the class count (80 -> 64 on n).
    assert stats["skipped"] and all(k.startswith(("head.cv3.", "head.one2one_cv3.")) for k in stats["skipped"])
    assert_state_equals_jax(tdst, jdst.params)


def test_transfer_load_of_a_lean_pt(tmp_path):
    """A lean `.pt` of an 80-class model (params_to_torch_sd: OIHW kernels,
    input norms [1, 3, 1, 1]) goes into a 7-class model as the same model's
    `.npz` goes through JAX: the same statistics and the same state, the
    input norms and conv kernels loaded."""
    norms = {"input_subtract": jnp.asarray([1.0, 2.0, 3.0]), "input_divide": jnp.asarray([4.0, 5.0, 6.0])}
    jm = JYOLOv10(cfg=JVARIANTS["yolov10n"], class_names=list(NAMES80), params={**jax_params("yolov10n"), **norms})
    npz, pt = str(tmp_path / "coco.npz"), str(tmp_path / "coco.pt")
    jregistry.save_checkpoint(jm, npz)
    src = load_jax_params(YOLOv10.create("yolov10n", class_names=NAMES80), jm.params)
    torch.save({"model": {"state_dict": params_to_torch_sd(src)}}, pt)
    names7 = [f"k{i}" for i in range(7)]
    jdst = JYOLOv10.create("yolov10n", class_names=names7, seed=4)
    tdst = load_jax_params(YOLOv10.create("yolov10n", class_names=names7), jdst.params)
    with pytest.warns(RuntimeWarning, match="Transfer load"):
        jstats = jregistry.load_checkpoint_transfer(jdst, npz)
    with pytest.warns(RuntimeWarning, match="Transfer load"):
        stats = registry.load_checkpoint_transfer(tdst, pt)
    assert stats == jstats
    assert stats["skipped"] and all(k.startswith(("head.cv3.", "head.one2one_cv3.")) for k in stats["skipped"])
    assert_state_equals_jax(tdst, jdst.params)
    assert tdst.input_subtract.tolist() == [1.0, 2.0, 3.0] and tdst.input_divide.tolist() == [4.0, 5.0, 6.0]


# ---------------------------------------------------------------------------
# The slice on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loaded_pair(tmp_path_factory):
    """yolov10s from one fused official-format file, loaded by each package's
    get_model(PRETRAINED_COCO) through LEANYOLO_WEIGHTS_DIR."""
    wdir = tmp_path_factory.mktemp("weights")
    sd, _ = fuse_repvggdw_keys(official_sd(jax_params("yolov10s")))
    emit_official_ckpt(sd, wdir / "yolov10s.pt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LEANYOLO_WEIGHTS_DIR", str(wdir))
        mp.setenv("LEANYOLO_CACHE_DIR", str(wdir / "cache"))
        tm, _ = _pretrained_or_fail(get_model, "yolov10s")
        jm, _ = _pretrained_or_fail(jget_model, "yolov10s")
    return jm, tm


def test_slice_head_maps_match_jax(loaded_pair):
    jm, tm = loaded_pair
    imgs = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    ref = model_apply(fold_params(jm.params), jnp.asarray(imgs).astype(jnp.float32), jm.cfg, train=False,
                      branches=("one2one",), normalize=False, concat_head=False)["one2one"]
    got = Predictor(tm, imgsz=64, dtype="float32", fuse=True, device="cpu").raw(imgs)
    for r_lvl, g_lvl in zip(ref, got):
        for r, g in zip(r_lvl, g_lvl):
            r, g = as_f32(r), as_f32(g)
            assert g.shape == r.shape
            assert np.max(np.abs(g - r)) <= 5e-4 * max(1.0, np.max(np.abs(r)))


@pytest.mark.parametrize("decode,size", [("topk", 64), ("nms", 128)])
def test_slice_dets_match_jax(loaded_pair, decode, size):
    """Detections of the loaded model through the port's Predictor against
    JAX's: counts and classes bit-exact, scores and boxes (in pixels) within
    5e-4 (fp32). Top-k ranks whose score is within 1e-4 of a neighbour's may
    come in either order under fp32 noise: they are compared as a set per
    image."""
    jm, tm = loaded_pair
    imgs = np.random.RandomState(1).randint(0, 256, (2, size, size, 3)).astype(np.uint8)
    kw = dict(imgsz=size, decode=decode, dtype="float32", fuse=True)
    jd, jn = JPredictor(jm, donate=False, **kw).run_batch(jnp.asarray(imgs))
    jd, jn = np.asarray(jd), np.asarray(jn)
    td, tn = Predictor(tm, device="cpu", **kw).run_batch(imgs)
    td, tn = td.numpy(), tn.numpy()
    assert td.shape == jd.shape and td.dtype == np.float32 and tn.dtype == np.int32
    np.testing.assert_array_equal(tn, jn)
    if decode == "nms":
        assert int(tn.min()) >= 3
        sel = np.ones(jd.shape[:2], bool)
    else:
        s = jd[..., 4]
        gap = np.minimum(np.abs(np.diff(s, axis=1, prepend=np.inf)), np.abs(np.diff(s, axis=1, append=-np.inf)))
        sel = gap > 1e-4
        assert sel.sum() >= 10, sel.sum()
    np.testing.assert_array_equal(td[..., 5][sel], jd[..., 5][sel])
    np.testing.assert_allclose(td[..., 4][sel], jd[..., 4][sel], rtol=0, atol=5e-4)
    np.testing.assert_allclose(td[..., :4][sel], jd[..., :4][sel], rtol=0, atol=5e-4)
    for b in range(jd.shape[0]):
        pool = list(jd[b][~sel[b]])
        for row in td[b][~sel[b]]:
            hit = next((i for i, r in enumerate(pool) if r[5] == row[5] and abs(r[4] - row[4]) <= 5e-4
                        and np.all(np.abs(r[:4] - row[:4]) <= 5e-4)), None)
            assert hit is not None, (b, row)
            pool.pop(hit)
