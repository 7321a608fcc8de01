"""Spatial parallelism in the port (`parallel/spatial.py`, the band-aware
layers, `Predictor(mesh=make_sp_mesh(...))`) on the CPU.

- The band plans, and each band-aware op on bands against the whole op, in
  one process: the ranks of a space group run as threads that exchange
  through a barrier (`Space(exchange=)`), fp32, within 5e-4 of the output's
  scale (max(1, max|y|)): the fused stem, s2dconv, dw7x7, cuDNN 3x3 convs
  at stride 1 and 2 (dense and depthwise), the SPPF pools with -inf edges
  and `Attention`, on an even plan (64 px over 4), an uneven one (96 px over
  4: bands of 2, 2, 1 and 1 rows at stride 16) and 64 px over 8 (1-row
  bands at stride 8, strides 16 and 32 whole). A pool edge filled with 0
  instead of -inf gives another answer on SiLU-negative inputs.
- One spawn of 4 gloo ranks (this file run as a script, `_worker`): the
  port's Predictor on make_sp_mesh(2, 2) and make_sp_mesh(1, 4) (whose 64 px
  plan leaves stride 32 whole), both decodes, unfolded and folded, against
  JAX's Predictor on the same meshes (virtual CPU devices,
  tests/conftest.py; rtol = atol = 1e-4, JAX's own tolerance, on the rows
  whose scores no near-tie can reorder) and against the port's one-process
  predictor (5e-4); detection counts equal.
- chip_smoke.py's check of each op on its band or channel slice
  (`split_ops`) on the CPU: every op within the CPU's own order of sums of
  the whole op over 2, 4 and 8 bands and 2 channel slices, and a wrong halo
  row found at its op alone; the top-k rows `split_decided` keeps.
- The dry run on 4 ranks prints sp=True tp=True.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.nn.functional as F

S, B, NC = 64, 2, 2
WORLD = 4
MESHES = {"sp22": (2, 2), "sp14": (1, 4)}
DECODES = {"topk": dict(decode="topk"), "nms": dict(decode="nms", conf_thresh=0.01, class_wise_nms=True)}


# --------------------------------------------------------------------------- ranks as threads


def _banded(fn, x, height: int, n: int, level: int, dim: int = 2):
    """fn on each rank's band of x (the whole map at stride `level` of a
    `height`-px image), the ranks as threads (chip_smoke.BandThreads) ->
    every rank's output."""
    from chip_smoke import BandThreads
    from leanyolo_tpu_torch.models.yolov10.layers import node, split_forward
    from leanyolo_tpu_torch.parallel.spatial import Space, plan_bands

    plan = plan_bands(height, n)
    threads = BandThreads(n)

    def run(pos):
        sp = Space(plan, None, pos, threads.exchange(pos))
        with torch.no_grad(), split_forward(sp):
            return node(False, level, fn, sp.take_band(x, level, dim))

    return threads.run(run), plan


def _joined(outs, plan, level: int, dim: int = 2):
    """The whole output from the ranks' outputs at stride `level`: their
    bands in order where the level splits, else each rank's (all equal)."""
    if plan.split(level):
        return torch.cat(outs, dim)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0]


def _close(got, want):
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= 5e-4 * max(1.0, float(want.abs().max())), err


PLANS = [(64, 4), (96, 4), (64, 8)]


def test_band_plans():
    from leanyolo_tpu_torch.parallel.spatial import STRIDES, plan_bands

    for n in (2, 4):  # at 640 px every level splits
        plan = plan_bands(640, n)
        assert plan.deepest == 32 and all(plan.split(s) for s in STRIDES)
        assert plan.heights(32) == [20 // n] * n and plan.band(1, n - 1) == (640 - 640 // n, 640)
    p = plan_bands(64, 4)
    assert p.deepest == 16 and p.heights(16) == [1] * 4 and not p.split(32) and p.band(32, 3) == (0, 2)
    p = plan_bands(96, 4)
    assert p.heights(16) == [2, 2, 1, 1] and p.heights(1) == [32, 32, 16, 16]
    p = plan_bands(64, 8)
    assert p.deepest == 8 and p.heights(8) == [1] * 8 and not p.split(16)
    for h, n in ((640, 4), (96, 4), (64, 8)):  # bands start on even rows wherever a stride-2 conv reads them
        plan = plan_bands(h, n)
        assert all(lo % 2 == 0 for s in STRIDES if s < plan.deepest for lo, _ in
                   (plan.band(s, r) for r in range(n)))
    assert not plan_bands(64, 32).split(1)  # fewer rows than ranks at stride 4: nothing splits
    assert plan_bands(640, 1).deepest == 0


def _conv(c_in, c_out, k, stride=1, groups=1, seed=0):
    from leanyolo_tpu_torch.models.yolov10.layers import ConvBNAct

    g = torch.Generator().manual_seed(seed)
    m = ConvBNAct(c_in, c_out, k, stride=stride, groups=groups, generator=g).eval()
    with torch.no_grad():
        m.bn.running_mean.uniform_(-0.2, 0.2, generator=g)
        m.bn.bias.uniform_(-0.5, 0.5, generator=g)
    return m


def _map(b, c, h, w, seed=1):
    return torch.randn(b, c, h, w, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("height,n", PLANS)
@pytest.mark.parametrize("kind", ["dense", "depthwise"])
@pytest.mark.parametrize("stride", [1, 2])
def test_cudnn_conv_on_bands(height, n, kind, stride):
    """3x3 convs at every level they meet a band edge at, stride 1 and 2."""
    for level in (4, 8, 16):
        c = 8
        m = _conv(c, c, 3, stride=stride, groups=c if kind == "depthwise" else 1)
        x = _map(2, c, height // level, 5)
        outs, plan = _banded(m, x, height, n, level)
        with torch.no_grad():
            _close(_joined(outs, plan, level * stride), m(x))


@pytest.mark.parametrize("height,n", PLANS)
def test_dw7x7_and_s2dconv_on_bands(height, n):
    from leanyolo_tpu_torch.models.yolov10.fold import fold_module
    from leanyolo_tpu_torch.models.yolov10.layers import RepVGGDW, FusedRepVGGDW, S2DConvBNAct

    rep = RepVGGDW(16, generator=torch.Generator().manual_seed(2)).eval()
    fused = fold_module(rep)
    s2d = fold_module(_conv(32, 32, 3, seed=3))
    assert isinstance(fused, FusedRepVGGDW) and isinstance(s2d, S2DConvBNAct)
    for m, c, level in ((fused, 16, 16), (fused, 16, 8), (s2d, 32, 4), (s2d, 32, 8)):
        x = _map(2, c, height // level, 6)
        with torch.no_grad():
            want = m(x)
        outs, plan = _banded(m, x, height, n, level)
        _close(_joined(outs, plan, level), want)


@pytest.mark.parametrize("height,n", PLANS)
def test_fused_stem_on_bands(height, n):
    """The folded stem on bands of image rows (uint8, the kernel's own zero
    padding at the image's top) against the whole stem."""
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.models.yolov10.fold import fold_model

    bb = fold_model(YOLOv10.create("yolov10n", class_names=["a"], seed=4)).backbone
    x = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (2, height, 40, 3)).astype(np.uint8))
    stem = lambda t: bb.stem(t, torch.float32)
    outs, plan = _banded(stem, x, height, n, 1, dim=1)
    with torch.no_grad():
        _close(_joined(outs, plan, 4), stem(x))


@pytest.mark.parametrize("height,n", PLANS)
def test_sppf_pools_on_bands_fill_minus_inf(height, n):
    """SPPF (1x1, three chained 5x5 pools, 1x1) at stride 32 and its pools at
    stride 16 on SiLU-like negative maps; a band filled with 0 beyond the
    image differs there."""
    from leanyolo_tpu_torch.models.yolov10.layers import SPPF, maxpool2d_same
    from leanyolo_tpu_torch.parallel.spatial import Space, plan_bands

    sppf = SPPF(16, 16, generator=torch.Generator().manual_seed(6)).eval()
    x = _map(2, 16, height // 32, 7)
    with torch.no_grad():
        want = sppf(x)
    outs, plan = _banded(sppf, x, height, n, 32)
    _close(_joined(outs, plan, 32), want)

    neg = -0.2785 - _map(2, 8, height // 16, 8).abs()  # below SiLU's minimum: every value negative
    want = maxpool2d_same(neg, 5)
    outs, plan = _banded(lambda t: maxpool2d_same(maxpool2d_same(t, 5), 5), neg, height, n, 16)
    _close(_joined(outs, plan, 16), maxpool2d_same(want, 5))
    # A zero fill at the image's top lets 0 win the top rows' windows.
    sp = Space(plan_bands(height, 1), None, 0, lambda t: [t])
    zero = F.max_pool2d(F.pad(neg, (0, 0, 2, 2)), 5, stride=1, padding=(0, 2))
    assert float((zero - want).abs().max()) > 0.1 and torch.equal(zero[:, :, 0], torch.zeros_like(zero[:, :, 0]))
    assert sp.halo(neg, 16, 2, 2, float("-inf")).shape[2] == neg.shape[2] + 4


@pytest.mark.parametrize("height,n", PLANS)
def test_attention_on_bands(height, n):
    """PSA's attention: each band's queries against every row's keys and
    values, its positional conv on the band with a halo."""
    from leanyolo_tpu_torch.models.yolov10.layers import PSA

    psa = PSA(128, generator=torch.Generator().manual_seed(9)).eval()
    for level in (16, 32):
        x = _map(2, 128, height // level, 10)
        with torch.no_grad():
            want = psa(x)
        outs, plan = _banded(psa, x, height, n, level)
        _close(_joined(outs, plan, level), want)


@pytest.mark.parametrize("height,n", PLANS)
@pytest.mark.parametrize("fuse", [False, True])
def test_whole_model_on_bands(height, n, fuse):
    """yolov10s's backbone, neck and head on bands (the neck's upsamples of
    whole levels cut to the band), the head maps joined per level."""
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.models.yolov10.fold import fold_model

    model = YOLOv10.create("yolov10s", class_names=["a", "b"], seed=11).eval()
    if fuse:
        model = fold_model(model)
    x = torch.from_numpy(np.random.RandomState(12).randint(0, 256, (1, height, height, 3)).astype(np.uint8))
    fwd = lambda t: model(t, branches=("one2one",), normalize=not fuse)["one2one"]
    with torch.no_grad():
        want = fwd(x)
    outs, plan = _banded(fwd, x, height, n, 1, dim=1)
    for i, w in enumerate(want):
        _close(_joined([o[i] for o in outs], plan, 8 << i, dim=1), w)


def _split_check_model(monkeypatch):
    """chip_smoke.py's op-by-op split check at 64 px on the CPU: the module
    with IMGSZ 64, a folded fp32 yolov10n predictor and two images."""
    import chip_smoke as cs
    from leanyolo_tpu_torch import Predictor, YOLOv10

    monkeypatch.setattr(cs, "IMGSZ", S)
    model = YOLOv10.create("yolov10n", class_names=["a", "b"], seed=13)
    x = torch.from_numpy(np.random.RandomState(14).randint(0, 256, (B, S, S, 3)).astype(np.uint8))
    return cs, Predictor(model, imgsz=S, fuse=True, device="cpu"), x


@pytest.mark.parametrize("kind,n", [("sp", 2), ("sp", 4), ("sp", 8), ("tp", 2)])
def test_chip_smoke_split_ops_hold_each_op(monkeypatch, kind, n):
    """chip_smoke.py's check of each op on its band or channel slice, given
    the whole run's input rows: every op of the folded serving path is
    called on every rank, and each agrees with the whole op (fp32, the
    CPU's own order of sums aside); the threads' gathered maps equal one
    process's."""
    cs, pm, x = _split_check_model(monkeypatch)
    with torch.no_grad():
        rep = cs.split_ops(pm, x, kind, n)
        ref = pm.raw(x)
        got = cs.split_raw(pm, x, kind, n)
    assert len(rep) == 85 and {r["op"] for r in rep if not r["lib"]} >= {"stem", "SPPF pool"}
    for r in rep:
        assert r["max"] <= 1e-5 * r["scale"], r
    for lvl, rl in zip(got, ref):
        for a, b in zip(lvl, rl):
            _close(a, b)


def test_chip_smoke_split_ops_isolate_a_wrong_halo(monkeypatch):
    """A halo whose nearest row from the rank above is wrong, in dw7x7's
    exchange alone, is found at that op and no other: each op reads the
    whole run's rows, so an error does not flow on."""
    from leanyolo_tpu_torch.parallel import spatial

    cs, pm, x = _split_check_model(monkeypatch)
    halo = spatial.Space.halo

    def wrong(self, t, level, above, below, fill, dim=2):
        y = halo(self, t, level, above, below, fill, dim)
        if above == 3 and self.pos > 0:
            y = y.clone()
            y.narrow(dim, above - 1, 1).fill_(1.0)
        return y

    monkeypatch.setattr(spatial.Space, "halo", wrong)
    with torch.no_grad():
        rep = cs.split_ops(pm, x, "sp", 2)
    bad = [r for r in rep if r["max"] > 1e-5 * r["scale"]]
    assert [r["op"] for r in bad] == ["neck.p4_p5_c2f.m.0.cv1.2 FusedRepVGGDW.forward"] and not bad[0]["lib"]


def test_chip_smoke_split_decided_rows():
    """The top-k rows whose order the one-process path's own bf16 rounding
    cannot change: each gap to a neighbour beyond the two rows' gaps to
    fp32."""
    import chip_smoke as cs

    v = torch.tensor([[9.0, 8.0, 7.9, 6.0, 5.0, 4.99]])
    e = torch.tensor([[0.1, 0.1, 0.1, 0.2, 0.3, 0.0]])
    assert cs.split_decided(v, e).tolist() == [[True, False, False, True, False]]
    assert not cs.split_decided(v, torch.full_like(e, 1.0)).any()


# --------------------------------------------------------------------------- the ranks


def _ranks(root: str) -> list:
    from leanyolo_tpu_torch.parallel.distributed import free_port
    from leanyolo_tpu_torch.parallel.dryrun import check_ranks, spawn_ranks

    port = free_port()
    results = spawn_ranks(lambda r: [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world",
                                     str(WORLD), "--port", str(port), "--root", root], WORLD, timeout=300)
    check_ranks(results, "the space-parallel ranks")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True) for r in range(WORLD)]


def _images() -> np.ndarray:
    return np.random.RandomState(3).randint(0, 256, (B, S, S, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' detections beside the port's one-process and JAX's mesh
    predictors on the same model and images."""
    import jax.numpy as jnp

    from leanyolo_tpu.engine.predictor import Predictor as JPredictor
    from leanyolo_tpu.parallel.mesh import make_sp_mesh as jmake_sp_mesh
    from leanyolo_tpu_torch import Predictor
    from torch_parity import jax_and_port_models

    root = str(tmp_path_factory.mktemp("spatial"))
    jm, tm = jax_and_port_models("yolov10n", NC, 0)
    torch.save({"state": tm.state_dict()}, os.path.join(root, "inputs.pt"))
    imgs = _images()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_ranks, root)
        ref = {}
        for d, kw in DECODES.items():
            for fuse in (False, True):
                ref[(d, fuse)] = Predictor(tm, imgsz=S, fuse=fuse, device="cpu", **kw).run_batch(imgs)
            for name, shape in MESHES.items():
                jd, jn = JPredictor(jm, imgsz=S, donate=False, mesh=jmake_sp_mesh(*shape), **kw).run_batch(
                    jnp.asarray(imgs))
                ref[("jax", name, d)] = (np.asarray(jd), np.asarray(jn))
        got = ranks.result()
    return {"ranks": got, "ref": ref}


def _decided(scores: np.ndarray, gap: float = 1e-4) -> np.ndarray:
    """Rows whose score no neighbour comes within `gap` of (their order is decided)."""
    d = np.minimum(np.abs(np.diff(scores, axis=1, prepend=np.inf)), np.abs(np.diff(scores, axis=1, append=-np.inf)))
    return d > gap


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("decode", sorted(DECODES))
def test_sp_predictor_matches_jax_mesh(run, mesh, decode):
    jd, jn = run["ref"][("jax", mesh, decode)]
    for rk in run["ranks"]:
        td, tn = (t.numpy() for t in rk[(mesh, decode, False)])
        np.testing.assert_array_equal(tn, jn)
        assert td.shape == jd.shape
        keep = _decided(jd[..., 4]) if decode == "topk" else np.ones(jd.shape[:2], bool)
        assert keep.sum() >= 10
        np.testing.assert_array_equal(td[..., 5][keep], jd[..., 5][keep])
        np.testing.assert_allclose(td[..., :5][keep], jd[..., :5][keep], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("decode", sorted(DECODES))
@pytest.mark.parametrize("fuse", [False, True])
def test_sp_predictor_matches_one_process(run, mesh, decode, fuse):
    dets, num = (t.numpy() for t in run["ref"][(decode, fuse)])
    for rk in run["ranks"]:
        td, tn = (t.numpy() for t in rk[(mesh, decode, fuse)])
        np.testing.assert_array_equal(tn, num)
        np.testing.assert_array_equal(td[..., 5], dets[..., 5])
        np.testing.assert_allclose(td[..., 4], dets[..., 4], rtol=0, atol=5e-4)
        np.testing.assert_allclose(td[..., :4], dets[..., :4], rtol=0, atol=5e-4 * S)


def test_sp_ranks_agree_and_exchange(run):
    """Every rank returns the same detections; halos crossed on every
    rank, and on the (1, 4) mesh the whole level at stride 32 was gathered."""
    for key in run["ranks"][0]:
        if isinstance(key, tuple):
            for rk in run["ranks"][1:]:
                assert all(torch.equal(a, b) for a, b in zip(rk[key], run["ranks"][0][key])), key
    for rk in run["ranks"]:
        assert rk["traffic"]["sp14"]["halo"] > 0 and rk["traffic"]["sp14"]["rows"] > 0
        assert rk["plans"]["sp14"].startswith("64 px over 4") and "/32: whole 2" in rk["plans"]["sp14"]


def test_placements_hold_this_ranks_part(run):
    """image_sharded: the rank's batch rows over `data` and its band of image
    rows over `space`; rows_sharded: its batch rows; replicated: all."""
    from leanyolo_tpu_torch.parallel.spatial import plan_bands

    imgs = torch.from_numpy(_images())
    for r, rk in enumerate(run["ranks"]):
        for name, (n_data, n_space) in MESHES.items():
            d, s = divmod(r, n_space)
            rows = slice(d * B // n_data, (d + 1) * B // n_data)
            lo, hi = plan_bands(S, n_space).band(1, s)
            held = rk["held"][name]
            assert torch.equal(held["image_sharded"], imgs[rows, lo:hi])
            assert torch.equal(held["rows_sharded"], imgs[rows]) and torch.equal(held["replicated"], imgs)


def test_dryrun_multichip_on_four_ranks(capsys):
    from leanyolo_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(4, timeout=300)
    assert "sp=True tp=True" in line and line.startswith("dryrun_multichip(4) OK")
    assert capsys.readouterr().out.strip().endswith(line)


def _worker(argv) -> None:
    p = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--root", required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from leanyolo_tpu_torch import Predictor, YOLOv10
    from leanyolo_tpu_torch.parallel.distributed import init_distributed
    from leanyolo_tpu_torch.parallel.mesh import image_sharded, make_sp_mesh, replicated, rows_sharded

    init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank, device="cpu")
    model = YOLOv10.create("yolov10n", class_names=[f"c{i}" for i in range(NC)])
    model.load_state_dict(torch.load(os.path.join(args.root, "inputs.pt"), weights_only=True)["state"])
    imgs = _images()
    out = {"traffic": {}, "plans": {}, "held": {}}
    for name, shape in MESHES.items():
        mesh = make_sp_mesh(*shape, device="cpu")
        out["held"][name] = {f.__name__: torch.from_numpy(np.ascontiguousarray(f(mesh)(imgs)))
                             for f in (image_sharded, rows_sharded, replicated)}
        for d, kw in DECODES.items():
            for fuse in (False, True):
                pred = Predictor(model, imgsz=S, fuse=fuse, device="cpu", mesh=mesh, **kw)
                out[(name, d, fuse)] = pred.run_batch(imgs)
        out["traffic"][name] = dict(pred._space.traffic)
        out["plans"][name] = pred._space.plan.describe()
    torch.save(out, os.path.join(args.root, f"rank{args.rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _worker(sys.argv[1:])
