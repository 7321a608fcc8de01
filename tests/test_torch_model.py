"""The port's whole model (leanyolo_tpu_torch/models/yolov10/model.py) against
the JAX `model_apply`, on the same parameters and the same images.

fp32: every head map, both branches, concatenated or split, unfolded and
folded, agrees to < 5e-4 of the map scale. bf16 (folded and cast, the
serving path): the two frameworks round at the same points but sum convs in
another order; a one-ulp difference early on travels through the whole net.
The limit is 4 bf16 ulps (2^-8 each) of max(1, the map's largest
magnitude); measured on these inputs: at most 0.75 of them (the maps peak
near 0.3, so that is about 2.5 ulps of the map's own scale).
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10.fold import fold_params
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10, model_apply
from leanyolo_tpu_torch.models.yolov10.convert import load_jax_params
from leanyolo_tpu_torch.models.yolov10.fold import fold_model
from leanyolo_tpu_torch.models.yolov10.model import YOLOv10 as TYOLOv10
from torch_parity import as_f32, bf16_ulps, randomize_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_pair(name: str, nc: int, seed: int = 0):
    """(JAX model with randomized BN, port model loaded with the same params)."""
    jm = JYOLOv10.create(name, class_names=[f"c{i}" for i in range(nc)], seed=seed)
    params = randomize_bn(jm.params, np.random.RandomState(seed))
    tm = TYOLOv10.create(name, class_names=jm.class_names, seed=seed)
    return jm.cfg, params, load_jax_params(tm, params).eval()


@pytest.fixture(scope="module")
def pair_n():
    return make_pair("yolov10n", 8)


@pytest.fixture(scope="module")
def pair_s():
    return make_pair("yolov10s", 80)


def _images(seed: int, b: int = 2, s: int = 64) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (b, s, s, 3)).astype(np.uint8)


def _flat(maps):
    out = []
    for m in maps:
        out.extend(m if isinstance(m, (tuple, list)) else [m])
    return out


def _jax_maps(cfg, params, imgs, *, dtype, **kw):
    fn = jax.jit(lambda p, x: model_apply(p, x.astype(dtype), cfg, train=False, **kw))
    return jax.tree_util.tree_map(as_f32, fn(params, jnp.asarray(imgs)))


def _torch_maps(model, imgs, *, dtype, **kw):
    with torch.no_grad():
        out = model(torch.from_numpy(imgs), dtype=dtype, **kw)
    return {b: [tuple(as_f32(t) for t in m) if isinstance(m, tuple) else as_f32(m) for m in v] for b, v in out.items()}


def _assert_close(ref_maps, got_maps, rel):
    for ref, got in zip(_flat(ref_maps), _flat(got_maps)):
        assert got.shape == ref.shape
        err = np.max(np.abs(got - ref))
        assert err < rel * max(1.0, np.max(np.abs(ref))), (err, np.max(np.abs(ref)))


@pytest.mark.parametrize("concat_head", [True, False])
def test_forward_fp32_unfolded_n(pair_n, concat_head):
    cfg, params, model = pair_n
    imgs = _images(0)
    ref = _jax_maps(cfg, params, imgs, dtype=jnp.float32, concat_head=concat_head)
    got = _torch_maps(model, imgs, dtype=torch.float32, concat_head=concat_head)
    for branch in ("one2many", "one2one"):
        _assert_close(ref[branch], got[branch], 5e-4)


def test_forward_fp32_folded_s(pair_s):
    """The serving graph: folded, normalization in conv0, one2one, split head."""
    cfg, params, model = pair_s
    imgs = _images(1)
    kw = dict(branches=("one2one",), normalize=False, concat_head=False)
    ref = _jax_maps(cfg, fold_params(params), imgs, dtype=jnp.float32, **kw)
    got = _torch_maps(fold_model(model), imgs, dtype=torch.float32, **kw)
    _assert_close(ref["one2one"], got["one2one"], 5e-4)


def test_forward_fp32_unfolded_s_matches_folded(pair_s):
    _, _, model = pair_s
    imgs = _images(2)
    a = _torch_maps(model, imgs, dtype=torch.float32, branches=("one2one",))
    b = _torch_maps(fold_model(model), imgs, dtype=torch.float32, branches=("one2one",), normalize=False)
    _assert_close(a["one2one"], b["one2one"], 5e-4)


@pytest.mark.parametrize("which", ["n", "s"])
def test_forward_bf16_folded(pair_n, pair_s, which):
    cfg, params, model = pair_n if which == "n" else pair_s
    imgs = _images(3)
    kw = dict(branches=("one2one",), normalize=False, concat_head=False)
    ref = _jax_maps(cfg, fold_params(params, dtype=jnp.bfloat16), imgs, dtype=jnp.bfloat16, **kw)
    got = _torch_maps(fold_model(model, dtype=torch.bfloat16), imgs, dtype=torch.bfloat16, **kw)
    for r, g in zip(_flat(ref["one2one"]), _flat(got["one2one"])):
        err = np.max(np.abs(g - r))
        assert err <= bf16_ulps(r, 4), (err, np.max(np.abs(r)))


def test_port_imports_no_jax():
    """The whole port imports in a process that never loads JAX or the JAX package."""
    code = (
        "import sys, pkgutil, importlib, leanyolo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'leanyolo_tpu'\n"
        "       or m.startswith('leanyolo_tpu.') or m.startswith('experiments')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('leanyolo_tpu_torch')]))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15


def test_no_jax_import_in_sources():
    """No port module and not chip_smoke.py names JAX, the JAX package or experiments/."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax\b|leanyolo_tpu(?!_torch)\b|experiments\b)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "leanyolo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f
