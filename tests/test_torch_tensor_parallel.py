"""Tensor parallelism in the port (`parallel/tensor.py`, `tp_shard_params`,
`Predictor(mesh=make_tp_mesh(...))`) on the CPU.

- `shard_layers` on folded yolov10n and yolov10s in one process: which
  layers split and which stay whole (the fused stem and the s2dconv convs),
  and the packed kernel weights packed again from the slices.
- One spawn of 4 gloo ranks (this file run as a script, `_worker`) on
  make_tp_mesh(2, 2):
  - the port's Predictor, both decodes, unfolded and folded, against JAX's
    Predictor on the same mesh (virtual CPU devices, tests/conftest.py;
    rtol = atol = 1e-4 on the rows whose scores no near-tie can reorder)
    and against the port's one-process predictor (5e-4); detection counts
    equal;
  - each rank's parameter shapes after `tp_shard_params` against JAX's
    `tp_shard_params` shard shapes leaf by leaf (through convert.py's key
    map), but for the layers listed as whole;
  - the port's version of JAX's test_predictors_sharing_a_model_stay_isolated:
    a tensor-parallel predictor leaves the caller's model whole, a plain
    predictor built before it answers as before, and both take new weights
    through update_params.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

S, B, NC = 64, 2, 2
WORLD = 4
DECODES = {"topk": dict(decode="topk"), "nms": dict(decode="nms", conf_thresh=0.01, class_wise_nms=True)}


@pytest.mark.parametrize("name", ["yolov10n", "yolov10s"])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_layers_split_and_whole(name, n):
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.models.yolov10 import layers as L
    from leanyolo_tpu_torch.models.yolov10.fold import fold_model
    from leanyolo_tpu_torch.parallel.tensor import shard_layers

    full = fold_model(YOLOv10.create(name, class_names=["a", "b"], seed=1))
    part = shard_layers(fold_model(YOLOv10.create(name, class_names=["a", "b"], seed=1)), n, n - 1)
    plan = part.tp_plan
    assert {"backbone.cv0", "backbone.cv1"} <= set(plan["whole"])
    s2d = [k for k, m in part.named_modules() if isinstance(m, L.S2DConvBNAct)]
    assert s2d and set(s2d) <= set(plan["whole"])
    assert ("head.cv3.0.2" in plan["whole"]) == (n == 4)  # 2 classes: whole over 4 ranks
    mods = dict(full.named_modules())
    for k in plan["split"]:
        a, b = mods[k], part.get_submodule(k)
        ca, cb = (a.conv, b.conv) if isinstance(a, L.ConvBNAct) else (a, b)
        o = ca.weight.shape[0]
        sl = slice((n - 1) * o // n, o)
        assert torch.equal(cb.weight, ca.weight[sl]) and b.tp_split == (n, n - 1)
        if isinstance(cb, L.MatmulConv):
            assert torch.equal(cb.wt, ca.wt[:, sl])
        if isinstance(b, L.FusedRepVGGDW):
            assert torch.equal(b.w49, a.w49[:, sl]) and cb.channels == sl and cb.groups == o // n
    for k in plan["whole"]:
        assert part.get_submodule(k).tp_split is None
    assert len(plan["split"]) > 50


def _ranks(root: str) -> list:
    from leanyolo_tpu_torch.parallel.distributed import free_port
    from leanyolo_tpu_torch.parallel.dryrun import check_ranks, spawn_ranks

    port = free_port()
    results = spawn_ranks(lambda r: [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world",
                                     str(WORLD), "--port", str(port), "--root", root], WORLD, timeout=300)
    check_ranks(results, "the tensor-parallel ranks")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True) for r in range(WORLD)]


def _images(seed: int = 5) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (B, S, S, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from leanyolo_tpu.engine.predictor import Predictor as JPredictor
    from leanyolo_tpu.parallel.mesh import make_tp_mesh as jmake_tp_mesh
    from leanyolo_tpu.parallel.mesh import tp_shard_params as jtp_shard_params
    from leanyolo_tpu_torch import Predictor
    from leanyolo_tpu_torch.models.yolov10.convert import flatten_param_paths
    from torch_parity import jax_and_port_models

    root = str(tmp_path_factory.mktemp("tensor"))
    jm, tm = jax_and_port_models("yolov10n", NC, 0)
    _, other = jax_and_port_models("yolov10n", NC, 1)
    torch.save({"state": tm.state_dict(), "other": other.state_dict()}, os.path.join(root, "inputs.pt"))
    imgs = _images()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_ranks, root)
        ref = {}
        for d, kw in DECODES.items():
            for fuse in (False, True):
                ref[(d, fuse)] = Predictor(tm, imgsz=S, fuse=fuse, device="cpu", **kw).run_batch(imgs)
            jd, jn = JPredictor(jm, imgsz=S, donate=False, mesh=jmake_tp_mesh(2, 2), **kw).run_batch(
                jnp.asarray(imgs))
            ref[("jax", d)] = (np.asarray(jd), np.asarray(jn))
        placed, _ = jtp_shard_params(jmake_tp_mesh(2, 2), jm.params)
        ref["shard_shapes"] = {p: (tuple(x.sharding.shard_shape(x.shape)), tuple(x.shape))
                               for p, x in flatten_param_paths(placed)}
        ref["other"] = Predictor(other, imgsz=S, device="cpu").run_batch(imgs)
        del placed
        jax.clear_caches()
        got = ranks.result()
    return {"ranks": got, "ref": ref}


def _decided(scores: np.ndarray, gap: float = 1e-4) -> np.ndarray:
    d = np.minimum(np.abs(np.diff(scores, axis=1, prepend=np.inf)), np.abs(np.diff(scores, axis=1, append=-np.inf)))
    return d > gap


@pytest.mark.parametrize("decode", sorted(DECODES))
def test_tp_predictor_matches_jax_mesh(run, decode):
    jd, jn = run["ref"][("jax", decode)]
    for rk in run["ranks"]:
        td, tn = (t.numpy() for t in rk[(decode, False)])
        np.testing.assert_array_equal(tn, jn)
        keep = _decided(jd[..., 4]) if decode == "topk" else np.ones(jd.shape[:2], bool)
        assert keep.sum() >= 10
        np.testing.assert_array_equal(td[..., 5][keep], jd[..., 5][keep])
        np.testing.assert_allclose(td[..., :5][keep], jd[..., :5][keep], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("decode", sorted(DECODES))
@pytest.mark.parametrize("fuse", [False, True])
def test_tp_predictor_matches_one_process(run, decode, fuse):
    dets, num = (t.numpy() for t in run["ref"][(decode, fuse)])
    for rk in run["ranks"]:
        td, tn = (t.numpy() for t in rk[(decode, fuse)])
        np.testing.assert_array_equal(tn, num)
        np.testing.assert_array_equal(td[..., 5], dets[..., 5])
        np.testing.assert_allclose(td[..., 4], dets[..., 4], rtol=0, atol=5e-4)
        np.testing.assert_allclose(td[..., :4], dets[..., :4], rtol=0, atol=5e-4 * S)


def test_tp_shard_shapes_match_jax(run):
    """Leaf by leaf, the port's shapes after tp_shard_params are JAX's shard
    shapes; the leaves of the layers kept whole keep the whole shape."""
    want = run["ref"]["shard_shapes"]
    for rk in run["ranks"]:
        shapes, whole = rk["shapes"], set(rk["plan"]["whole"])
        assert set(shapes) == set(want)
        kept = 0
        for path, (shard, full) in want.items():
            owner = path[:-2] if len(path) > 1 and path[-2] in ("conv", "bn") else path[:-1]
            layer = ".".join(str(c) for c in owner)
            if layer in whole and shard != full:
                assert shapes[path] == full, path
                kept += 1
            else:
                assert shapes[path] == shard, path
        # the stem's two convs and yolov10n's s2dconv convs (6), weight, bias and BN vectors each
        assert kept == (2 + 6) * 5


def test_tp_predictors_sharing_a_model_stay_isolated(run):
    """A tensor-parallel predictor leaves the caller's model whole; a plain
    predictor built before it answers as before and takes new weights;
    update_params on the tensor-parallel one slices what it is given."""
    other = run["ref"]["other"]
    for rk in run["ranks"]:
        iso = rk["isolation"]
        assert iso["model_whole"] and iso["plain_unchanged"] and iso["plain_again"]
        np.testing.assert_array_equal(iso["tp_updated"][1].numpy(), other[1].numpy())
        np.testing.assert_allclose(iso["tp_updated"][0].numpy(), other[0].numpy(), rtol=0, atol=5e-4 * S)


def test_tp_ranks_agree_and_gather_channels(run):
    for key in run["ranks"][0]:
        if isinstance(key, tuple):
            for rk in run["ranks"][1:]:
                assert all(torch.equal(a, b) for a, b in zip(rk[key], run["ranks"][0][key])), key
    assert all(rk["traffic"] > 0 for rk in run["ranks"])


def _worker(argv) -> None:
    p = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--root", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    import copy

    import torch.distributed as dist

    from leanyolo_tpu_torch import Predictor, YOLOv10
    from leanyolo_tpu_torch.models.yolov10.convert import module_leaves
    from leanyolo_tpu_torch.parallel import tensor
    from leanyolo_tpu_torch.parallel.distributed import init_distributed
    from leanyolo_tpu_torch.parallel.mesh import make_tp_mesh

    init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank, device="cpu")
    inputs = torch.load(os.path.join(args.root, "inputs.pt"), weights_only=True)

    def model(state):
        m = YOLOv10.create("yolov10n", class_names=[f"c{i}" for i in range(NC)])
        m.load_state_dict(state)
        return m

    tm = model(inputs["state"])
    imgs = _images()
    mesh = make_tp_mesh(2, 2, device="cpu")
    out = {"traffic": 0}
    for d, kw in DECODES.items():
        for fuse in (False, True):
            pm = Predictor(tm, imgsz=S, fuse=fuse, device="cpu", mesh=mesh, **kw)
            out[(d, fuse)] = pm.run_batch(imgs)
            out["traffic"] += pm._model_group.traffic["channels"]

    sliced = tensor.tp_shard_params(mesh, copy.deepcopy(tm))
    out["plan"] = sliced.tp_plan
    out["shapes"] = {path: tuple(t.permute(2, 3, 1, 0).shape) if t.ndim == 4 else tuple(t.shape)
                     for path, t in module_leaves(sliced)}

    shapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    plain = Predictor(tm, imgsz=S, device="cpu")
    before = plain.run_batch(imgs)
    tp = Predictor(tm, imgsz=S, device="cpu", mesh=mesh)
    tp.run_batch(imgs)
    iso = {"model_whole": {k: tuple(v.shape) for k, v in tm.state_dict().items()} == shapes,
           "plain_unchanged": all(torch.equal(a, b) for a, b in zip(before, plain.run_batch(imgs)))}
    plain.update_params(tm)
    iso["plain_again"] = all(torch.equal(a, b) for a, b in zip(before, plain.run_batch(imgs)))
    tp.update_params(model(inputs["other"]))
    iso["tp_updated"] = tp.run_batch(imgs)
    out["isolation"] = iso
    torch.save(out, os.path.join(args.root, f"rank{args.rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _worker(sys.argv[1:])
