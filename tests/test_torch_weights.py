"""The port's weight pipeline against the JAX package's: the keymap, the JAX
tree's leaf order, the official-checkpoint remap, the safe `.pt` reader and
the weights resolver (on a local HTTP server at 127.0.0.1; nothing is
downloaded from outside).

Official-format state dicts are made from seeded JAX parameters with
randomized BN statistics (JAX `params_to_torch_sd`, keys renamed to the
official `model.{idx}.` numbering), unfused, with the fused-RepVGGDW
spelling, and in fp16. The same dict goes through JAX's
`torch_sd_to_params(official=True)` and the port's `torch_sd_to_state`:
every leaf bit-equal (through `export_jax_params`) and every statistics
list equal, order included.
"""

from __future__ import annotations

import functools
import hashlib
import os
import sys
import threading
import types
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10 import keymap as jkeymap
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10
from leanyolo_tpu.models.yolov10.remap import flatten_param_paths as jflatten
from leanyolo_tpu.models.yolov10.remap import params_to_torch_sd as jparams_to_torch_sd
from leanyolo_tpu.models.yolov10.remap import path_to_torch_key as jpath_to_torch_key
from leanyolo_tpu.models.yolov10.remap import torch_sd_to_params
from leanyolo_tpu.utils import torch_reader as jreader
from leanyolo_tpu_torch import YOLOv10
from leanyolo_tpu_torch.models.yolov10 import keymap
from leanyolo_tpu_torch.models.yolov10.convert import (
    export_jax_params,
    flatten_param_paths,
    load_jax_params,
    module_leaves,
)
from leanyolo_tpu_torch.models.yolov10.remap import params_to_torch_sd, torch_sd_to_state
from leanyolo_tpu_torch.utils import torch_reader
from leanyolo_tpu_torch.utils.weights import WeightsEntry
from torch_parity import randomize_bn

ALL_VARIANTS = ["yolov10n", "yolov10s", "yolov10m", "yolov10b", "yolov10l", "yolov10x"]
NAMES80 = [f"c{i}" for i in range(80)]
FAKE_MODULE = "ultralytics.nn.tasks"  # not installed here: loading must stub it


# ---------------------------------------------------------------------------
# Official-format files from JAX parameters (helpers shared with
# test_torch_registry.py)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_template(name: str):
    """JAX's seeded 80-class parameters as `YOLOv10.create` makes them, in
    its leaf order (cached: JAX's init of the wide sizes takes seconds on
    the CPU)."""
    return JYOLOv10.create(name, class_names=NAMES80, seed=3).params


def _in_order(template, values):
    """`values` (same structure) rebuilt in `template`'s dict order."""
    if isinstance(template, dict):
        return {k: _in_order(template[k], values[k]) for k in template}
    if isinstance(template, list):
        return [_in_order(t, v) for t, v in zip(template, values)]
    return values


@functools.lru_cache(maxsize=None)
def jax_params(name: str):
    """The template with randomized BN statistics, kept in JAX's leaf order
    (randomize_bn rebuilds each BN dict in an order of its own)."""
    template = jax_template(name)
    return _in_order(template, randomize_bn(template, np.random.RandomState(3)))


def official_sd(params, dtype=torch.float32) -> dict:
    """A JAX parameter tree as an official checkpoint's flat state dict:
    OIHW torch tensors under `model.{idx}.` keys (the JAX keymap inverted),
    no input norms, a `num_batches_tracked` beside every BN."""
    inv = {lean: idx for table in (jkeymap.BACKBONE_MAP, jkeymap.NECK_MAP, jkeymap.HEAD_MAP)
           for idx, lean in table.items()}
    sd = {}
    for k, v in jparams_to_torch_sd(params).items():
        prefix = next((p for p in inv if k.startswith(p + ".")), None)
        if prefix is None:
            continue
        key = f"model.{inv[prefix]}." + k[len(prefix) + 1:]
        sd[key] = torch.from_numpy(np.array(v)).to(dtype)
        if key.endswith(".bn.running_var"):
            sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(100)
    return sd


def fuse_repvggdw_keys(sd: dict, eps: float = 1e-3):
    """Rewrite unfused RepVGGDW branches into the fused official layout (a
    copy of the JAX package's test helper `_fuse_repvggdw_keys`): each
    branch's BN folded into its conv, the padded kernels summed into one 7x7
    stored as `cv1.2.conv.weight`, and an identity-like BN `cv1.2.bn.*` that
    carries the combined bias; `conv1` dropped. Returns (sd, blocks fused)."""
    out = dict(sd)
    bases = sorted(k[: -len(".conv.conv.weight")] for k in sd if k.endswith(".cv1.2.conv.conv.weight"))
    for base in bases:
        merged = bias_total = None
        for branch, pad in (("conv", 0), ("conv1", 2)):
            w = out.pop(f"{base}.{branch}.conv.weight")
            g = out.pop(f"{base}.{branch}.bn.weight")
            b = out.pop(f"{base}.{branch}.bn.bias")
            m = out.pop(f"{base}.{branch}.bn.running_mean")
            v = out.pop(f"{base}.{branch}.bn.running_var")
            out.pop(f"{base}.{branch}.bn.num_batches_tracked", None)
            scale = g / torch.sqrt(v + eps)
            wf = w * scale.reshape(-1, 1, 1, 1)
            bf = b - m * scale
            if pad:
                wf = torch.nn.functional.pad(wf, (pad, pad, pad, pad))
            merged = wf if merged is None else merged + wf
            bias_total = bf if bias_total is None else bias_total + bf
        c = merged.shape[0]
        out[f"{base}.conv.weight"] = merged
        out[f"{base}.bn.weight"] = torch.ones(c)
        out[f"{base}.bn.bias"] = bias_total
        out[f"{base}.bn.running_mean"] = torch.zeros(c)
        out[f"{base}.bn.running_var"] = torch.full((c,), 1.0 - eps)
    return out, len(bases)


def module_like_tree(sd: dict):
    """An nn.Module-like object graph (a copy of the JAX package's test
    helper `_module_like_tree`) whose `_parameters`/`_buffers`/`_modules`
    reproduce the flat state dict: a release file's pickled DetectionModel.
    The caller has put FAKE_MODULE in `sys.modules`."""

    class _FakeDetectionModel:
        pass

    _FakeDetectionModel.__module__ = FAKE_MODULE
    _FakeDetectionModel.__qualname__ = "YOLOv10DetectionModel"
    setattr(sys.modules[FAKE_MODULE], "YOLOv10DetectionModel", _FakeDetectionModel)

    def node():
        o = _FakeDetectionModel()
        o.__dict__.update(_parameters={}, _buffers={}, _modules={})
        return o

    root = node()
    for key, tensor in sd.items():
        parts = key.split(".")
        cur = root
        for p in parts[:-1]:
            if p not in cur.__dict__["_modules"]:
                cur.__dict__["_modules"][p] = node()
            cur = cur.__dict__["_modules"][p]
        leaf = parts[-1]
        slot = "_buffers" if leaf in ("running_mean", "running_var", "num_batches_tracked") else "_parameters"
        cur.__dict__[slot][leaf] = tensor.detach().clone()
    return root


def emit_official_ckpt(sd: dict, path) -> str:
    """torch.save an ultralytics-style container (a copy of the JAX package's
    test helper `_emit_official_ckpt`), then drop the fake module, so that
    loading must go through the stubbed weights-only unpickler. Returns the
    file's SHA-256."""
    for name in ("ultralytics", "ultralytics.nn", FAKE_MODULE):
        sys.modules.setdefault(name, types.ModuleType(name))
    try:
        ckpt = {"model": module_like_tree(sd), "epoch": -1, "train_args": {"data": "coco.yaml"}}
        torch.save(ckpt, str(path))
    finally:
        for name in list(sys.modules):
            if name.startswith("ultralytics"):
                del sys.modules[name]
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


@pytest.fixture()
def http_server(tmp_path):
    """A local HTTP server over tmp_path/serve; yields (serve_dir, base_url)."""
    serve_dir = tmp_path / "serve"
    serve_dir.mkdir()

    class Handler(SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(serve_dir), **kw)

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield serve_dir, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)


def assert_state_equals_jax(module, jparams_tree) -> None:
    """Every leaf of `module` bit-equal to the JAX tree's, same paths."""
    want = dict(jflatten(jparams_tree))
    got = dict(flatten_param_paths(export_jax_params(module)))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, dtype=np.float32)
        assert got[path].shape == w.shape, path
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))


# ---------------------------------------------------------------------------
# Keymap and leaf order
# ---------------------------------------------------------------------------


def test_keymap_equals_jax():
    assert keymap.BACKBONE_MAP == jkeymap.BACKBONE_MAP
    assert keymap.NECK_MAP == jkeymap.NECK_MAP
    assert keymap.HEAD_MAP == jkeymap.HEAD_MAP
    assert keymap.REPVGGDW_FUSED_ALT == jkeymap.REPVGGDW_FUSED_ALT
    keys = list(official_sd(jax_params("yolov10n"))) + [
        "model.11.anything", "model.12", "model.x.conv.weight", "not_model.key", "model.23.dfl.conv.weight"]
    assert [keymap.official_key_to_lean(k) for k in keys] == [jkeymap.official_key_to_lean(k) for k in keys]
    assert keymap.official_key_to_lean("model.13.cv2.bn.bias") == "neck.p5_p4_c2f.cv2.bn.bias"


@pytest.mark.parametrize("name", ALL_VARIANTS)
def test_leaf_order_matches_jax(name):
    """`module_leaves` walks the module in the JAX tree's leaf order, which
    is not the module's own (c6/c8 after psa10, sorted one2one dicts, the
    input norms last), and names each leaf by its state-dict key."""
    want = [p for p, _ in jflatten(jax_template(name))]
    tm = YOLOv10.create(name, class_names=NAMES80)
    leaves = module_leaves(tm)
    assert [p for p, _ in leaves] == want
    assert [p for p, _ in flatten_param_paths(export_jax_params(tm))] == want
    own = tm.state_dict()
    assert sorted(own) == sorted(jpath_to_torch_key(p) for p in want)
    for p, t in leaves:
        assert torch.equal(t, own[jpath_to_torch_key(p)]), p


# ---------------------------------------------------------------------------
# The official remap
# ---------------------------------------------------------------------------


def _remap_both(name, sd):
    """JAX's remap into its template, the port's into a fresh module."""
    jp, jstats = torch_sd_to_params(sd, jax_template(name), official=True)
    tm = YOLOv10.create(name, class_names=NAMES80, seed=4)
    state, stats = torch_sd_to_state(sd, tm, official=True)
    tm.load_state_dict(state)
    return jp, jstats, tm, stats


@pytest.mark.parametrize("layout", ["unfused", "fused", "fp16"])
@pytest.mark.parametrize("name", ["yolov10n", "yolov10s", "yolov10x"])
def test_official_remap_matches_jax(name, layout):
    sd = official_sd(jax_params(name), torch.float16 if layout == "fp16" else torch.float32)
    n_fused = 0
    if layout == "fused":
        sd, n_fused = fuse_repvggdw_keys(sd)
        # n and s have RepVGGDW blocks (lk CIBs); x has plain CIBs, whose
        # direct `cv1.2.conv.weight` must not be renamed.
        assert (n_fused > 0) == (name != "yolov10x")
    jp, jstats, tm, stats = _remap_both(name, sd)
    assert stats == jstats
    assert not stats["missing"] and not stats["unused_src"] and not stats["shape_filled"]
    assert len({s.split(".conv1.")[0] for s in stats["synthesized"]}) == n_fused
    if name == "yolov10x":
        assert any(k.endswith(".cv1.2.conv.weight") for k in stats["matched"])
    assert_state_equals_jax(tm, jp)


@pytest.mark.parametrize("name", ["yolov10n", "yolov10s"])
def test_official_shape_fill_matches_jax(name):
    """Pass 3 fires: renamed keys are placed by shape, in the JAX tree's
    order; one renamed key fits nothing and stays unused."""
    sd = official_sd(jax_params(name))
    for k in ("model.0.conv.weight", "model.2.m.0.cv1.bn.weight", "model.2.m.0.cv1.bn.bias",
              "model.23.one2one_cv3.0.0.0.bn.bias", "model.23.one2one_cv3.0.0.0.bn.weight"):
        sd[k + "_renamed"] = sd.pop(k)
    sd["model.22.stray"] = torch.zeros(7, 7)
    jp, jstats, tm, stats = _remap_both(name, sd)
    assert stats == jstats
    assert len(stats["shape_filled"]) == 5 and stats["unused_src"] == ["neck.p4_p5_c2f.stray"]
    assert_state_equals_jax(tm, jp)


def test_remap_strict_refuses_what_jax_refuses():
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jparams_to_torch_sd(jax_params("yolov10n")).items()}
    template = jax_template("yolov10n")
    tm = YOLOv10.create("yolov10n", class_names=NAMES80)
    state, stats = torch_sd_to_state(sd, tm, strict=True)
    jp, jstats = torch_sd_to_params(sd, template, strict=True)
    assert stats == jstats and not stats["missing"]
    tm.load_state_dict(state)
    assert_state_equals_jax(tm, jp)
    for bad in ({k: v for k, v in sd.items() if k != "neck.p3_down.bn.bias"},
                {**sd, "extra.weight": torch.zeros(3)},
                {**sd, "neck.p3_down.bn.bias": torch.zeros(5)}):
        with pytest.raises(ValueError, match="strict load failed"):
            torch_sd_to_params(bad, template, strict=True)
        with pytest.raises(ValueError, match="strict load failed"):
            torch_sd_to_state(bad, tm, strict=True)


def test_params_to_torch_sd_matches_jax():
    params = jax_params("yolov10s")
    tm = load_jax_params(YOLOv10.create("yolov10s", class_names=NAMES80), params)
    want = jparams_to_torch_sd(params)
    got = params_to_torch_sd(tm)
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert tuple(got["input_subtract"].shape) == (1, 3, 1, 1)


# ---------------------------------------------------------------------------
# The safe .pt reader
# ---------------------------------------------------------------------------


def _containers():
    sd = {"layer.weight": torch.arange(6.0).reshape(2, 3).half(), "layer.bias": torch.ones(2, dtype=torch.bfloat16),
          "bn.num_batches_tracked": torch.tensor(7), "idx": torch.arange(3, dtype=torch.int32)}
    prefixed = {"module." + k: v for k, v in sd.items()}
    return {
        "flat": sd,
        "state_dict": {"state_dict": sd, "epoch": 3},
        "ema_prefixed": {"ema_state_dict": prefixed, "optimizer": {"lr": 0.1}},
        "nested": {"model": {"state_dict": prefixed}, "epoch": 1},
        "model_model": {"model.model.a.weight": torch.zeros(2), "model.0.conv.weight": torch.ones(1)},
    }


@pytest.mark.parametrize("form", list(_containers()))
def test_reader_matches_jax(tmp_path, form):
    """Floating tensors come back as fp32, integer ones keep their dtype;
    keys, order and values are the JAX reader's."""
    path = str(tmp_path / "c.pt")
    torch.save(_containers()[form], path)
    got = torch_reader.load_torch_checkpoint(path)
    want = jreader.load_torch_checkpoint(path)
    assert list(got) == list(want)
    for k, w in want.items():
        assert isinstance(got[k], torch.Tensor) and got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w)


def test_safe_unpickle_without_stub_module(tmp_path):
    """A release-style file whose class module cannot be imported loads
    through stubs, equals the JAX reader's result, and loads the same again
    once the stubs are registered, also after another such file is written."""
    from importlib.machinery import PathFinder

    assert PathFinder.find_spec("ultralytics") is None
    sd = official_sd(jax_params("yolov10n"), torch.float16)
    path = tmp_path / "yolov10n.pt"
    emit_official_ckpt(sd, path)
    first = torch_reader.load_torch_checkpoint(str(path))
    assert sorted(first) == sorted(sd)  # module-like order: parameters, then buffers
    for k, v in sd.items():
        assert torch.equal(first[k], v.float() if v.is_floating_point() else v), k
    emit_official_ckpt({"model.0.conv.weight": torch.zeros(1)}, tmp_path / "other.pt")
    again = torch_reader.load_torch_checkpoint(str(path))
    assert list(again) == list(first) and all(torch.equal(again[k], first[k]) for k in first)
    want = jreader.load_torch_checkpoint(str(path))
    assert list(want) == list(first)
    for k, w in want.items():
        np.testing.assert_array_equal(first[k].numpy(), w)


# ---------------------------------------------------------------------------
# The weights resolver
# ---------------------------------------------------------------------------


def _write_blob(path, payload: bytes) -> str:
    path.write_bytes(payload)
    return hashlib.sha256(payload).hexdigest()


def test_download_and_verify(http_server, tmp_path):
    serve_dir, url = http_server
    sha = _write_blob(serve_dir / "w.bin", b"hello weights")
    entry = WeightsEntry(name="t", url=f"{url}/w.bin", filename="w.bin", sha256=sha)
    cache = tmp_path / "cache"
    path = entry.resolve_path(cache_dir=str(cache))
    assert open(path, "rb").read() == b"hello weights"
    assert os.listdir(cache) == ["w.bin"]  # no temp file left behind
    (serve_dir / "w.bin").unlink()  # the second resolve is served from the cache
    assert entry.resolve_path(cache_dir=str(cache)) == path


def test_corrupted_cache_redownloads(http_server, tmp_path):
    serve_dir, url = http_server
    sha = _write_blob(serve_dir / "w.bin", b"payload-v2")
    entry = WeightsEntry(name="t", url=f"{url}/w.bin", filename="w.bin", sha256=sha)
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "w.bin").write_bytes(b"CORRUPT")
    path = entry.resolve_path(cache_dir=str(cache))
    assert open(path, "rb").read() == b"payload-v2"


def test_hash_mismatch_raises_and_deletes(http_server, tmp_path):
    serve_dir, url = http_server
    _write_blob(serve_dir / "w.bin", b"evil")
    entry = WeightsEntry(name="t", url=f"{url}/w.bin", filename="w.bin", sha256="0" * 64)
    with pytest.raises(RuntimeError, match="hash mismatch"):
        entry.resolve_path(cache_dir=str(tmp_path / "cache"))
    assert os.listdir(tmp_path / "cache") == []


def test_failed_download_leaves_no_file(http_server, tmp_path):
    _, url = http_server
    entry = WeightsEntry(name="t", url=f"{url}/missing.bin", filename="w.bin", sha256="0" * 64)
    with pytest.raises(OSError):
        entry.resolve_path(cache_dir=str(tmp_path / "cache"))
    assert os.listdir(tmp_path / "cache") == []


def test_env_dir_override_and_local_path(tmp_path, monkeypatch):
    """LEANYOLO_WEIGHTS_DIR wins over the cache, with no hash check (as in
    JAX); a local path wins over both; with neither and no URL, it raises."""
    env_dir = tmp_path / "weights"
    env_dir.mkdir()
    (env_dir / "w.bin").write_bytes(b"local")
    monkeypatch.setenv("LEANYOLO_WEIGHTS_DIR", str(env_dir))
    monkeypatch.setenv("LEANYOLO_CACHE_DIR", str(tmp_path / "cache"))
    entry = WeightsEntry(name="t", url=None, filename="w.bin", sha256="0" * 64)
    assert entry.resolve_path() == str(env_dir / "w.bin")
    assert entry.resolve_path(local_path="/some/file.pt") == "/some/file.pt"
    monkeypatch.delenv("LEANYOLO_WEIGHTS_DIR")
    with pytest.raises(FileNotFoundError, match="LEANYOLO_WEIGHTS_DIR"):
        entry.resolve_path()


def test_get_state_dict_reads_the_resolved_file(http_server, tmp_path):
    serve_dir, url = http_server
    sd = {"model.0.conv.weight": torch.arange(4.0).half()}
    sha = emit_official_ckpt(sd, serve_dir / "w.pt")
    entry = WeightsEntry(name="t", url=f"{url}/w.pt", filename="w.pt", sha256=sha)
    got = entry.get_state_dict(cache_dir=str(tmp_path / "cache"))
    assert list(got) == ["model.0.conv.weight"] and got["model.0.conv.weight"].dtype == torch.float32
    assert torch.equal(got["model.0.conv.weight"], torch.arange(4.0))
