"""The rest of the port's train step against the JAX trainer, on the CPU:
device letterboxing (`TrainConfig(device_preprocess=True)`, a `DeviceBatch`
from the loader), activation checkpointing (`remat="full"`), the batch /
preprocess mismatch, and the head reset (`reset_head`, JAX `head_init`).

yolov10n, batch 2, fp32, at 96 px (at 64 px the deepest batch-stat BNs see
8 values and amplify summation-order noise; see test_torch_train.py).

Tolerances:
- three whole train steps against JAX's, at lr 1e-4, as
  test_torch_train.py::test_three_train_steps_match_jax holds them: losses
  within 1e-4 relative, BN running statistics within 5e-4 of max(1, scale);
- `remat="full"` against the port's `remat="none"`: bit-equal (the
  recompute repeats the same operations on the same inputs), parameters,
  gradients and BN statistics;
- the device warp of images already at the letterbox size against the host
  path: losses within 1e-5 relative (the warp is then a copy).
The head reset cannot be bit-equal to JAX's PRNG: it is held in structure,
shapes and the init's bounds.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.data.dataset import Batch, CocoDetection as JCocoDetection, DataLoader as JDataLoader
from leanyolo_tpu.engine import trainer as JTr
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10, head_init as jhead_init
from leanyolo_tpu_torch import TrainConfig, Trainer, YOLOv10
from leanyolo_tpu_torch.data.dataset import CocoDetection, DataLoader
from leanyolo_tpu_torch.models.yolov10 import layers as TL
from leanyolo_tpu_torch.models.yolov10.convert import export_jax_params, flatten_param_paths, load_jax_params
from leanyolo_tpu_torch.models.yolov10.model import Head, reset_head
from torch_parity import make_mixed_coco, randomize_bn

S, NC = 96, 3
NAMES = ["rect", "circle", "triangle"]
STEP_CFG = dict(augment=False, grad_clip=1.0, steps_per_epoch=1000, lr=1e-4)


@pytest.fixture(scope="module")
def params():
    jm = JYOLOv10.create("yolov10n", class_names=NAMES, seed=0)
    return jm.cfg, randomize_bn(jm.params, np.random.RandomState(0))


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Six images at mixed sizes on full-range noise (see make_mixed_coco on
    why not the low-contrast default)."""
    return make_mixed_coco(str(tmp_path_factory.mktemp("mixed")), n_images=6, noise=(0, 256))


def _jax_trainer(cfg, params, tcfg):
    jm = JYOLOv10(cfg=cfg, class_names=NAMES, params=jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), params))
    return JTr.Trainer(jm, JTr.TrainConfig(**tcfg))


def _port(params) -> YOLOv10:
    return load_jax_params(YOLOv10.create("yolov10n", class_names=NAMES), params).train()


def _assert_steps_match(jt, tt, jbatches, tbatches):
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jl = jt.train_step(jb, jax.random.PRNGKey(i))
        tl = tt.train_step(tb)
        for k in ("total", "cls", "reg"):
            assert abs(float(tl[k]) - float(jl[k])) <= 1e-4 * abs(float(jl[k])), (i, k)
    got = dict(flatten_param_paths(export_jax_params(tt.model)))
    n = 0
    for path, ref in flatten_param_paths(jt.model.params):
        if path[-1] in ("mean", "var"):
            ref = np.asarray(ref)
            assert np.max(np.abs(got[path] - ref)) <= 5e-4 * max(1.0, np.max(np.abs(ref))), path
            n += 1
    assert n == 2 * sum(isinstance(m, TL.BatchNorm) for m in tt.model.modules())


def _host_batches(n: int):
    out = []
    for seed in range(n):
        rng = np.random.RandomState(20 + seed)
        x1, y1 = rng.uniform(0, S - 26, (2, 2, 5))
        wh = rng.uniform(6, 24, (2, 2, 5))
        boxes = np.stack([x1, y1, x1 + wh[0], y1 + wh[1]], axis=-1).astype(np.float32)
        mask = rng.uniform(size=(2, 5)) < 0.7
        mask[:, 0] = True
        out.append(Batch(rng.randint(0, 256, (2, S, S, 3)).astype(np.uint8),
                         rng.randint(0, NC, (2, 5)).astype(np.int32), boxes, mask, [None] * 2))
    return out


def test_three_device_preprocess_steps_match_jax(params, mixed):
    """Mixed-size images on a canvas, warped to 96 px in the step, boxes
    mapped by gain and pad: three steps from each package's own loader."""
    cfg, p = params
    img_dir, ann = mixed
    kw = dict(batch_size=2, shuffle=True, max_boxes=8, workers=2, seed=1)
    tbatches = list(DataLoader(CocoDetection(img_dir, ann, img_size=S, preprocess="device"), **kw))
    jbatches = list(JDataLoader(JCocoDetection(img_dir, ann, img_size=S, preprocess="device"), **kw))
    assert len(tbatches) == 3 and tbatches[0].canvas.shape[1] > S
    tcfg = dict(STEP_CFG, device_preprocess=True, imgsz=S)
    _assert_steps_match(_jax_trainer(cfg, p, tcfg), Trainer(_port(p), TrainConfig(**tcfg), device="cpu"),
                        jbatches, tbatches)


def test_three_remat_full_steps_match_jax(params):
    cfg, p = params
    tcfg = dict(STEP_CFG, remat="full")
    batches = _host_batches(3)
    _assert_steps_match(_jax_trainer(cfg, p, tcfg), Trainer(_port(p), TrainConfig(**tcfg), device="cpu"),
                        batches, batches)


def test_remat_full_equals_none_bit_for_bit(params, mixed):
    """Two steps (device preprocess and augmentation on, bf16 off): the
    checkpointed run's parameters, gradients and BN statistics equal the
    plain run's exactly."""
    _, p = params
    img_dir, ann = mixed
    batches = list(DataLoader(CocoDetection(img_dir, ann, img_size=S, preprocess="device"), batch_size=2,
                              max_boxes=8, workers=2))[:2]
    runs = {}
    for remat in ("none", "full"):
        tr = Trainer(_port(p), TrainConfig(augment=True, device_preprocess=True, imgsz=S, remat=remat,
                                           steps_per_epoch=1000), device="cpu")
        losses = [tr.train_step(b, torch.Generator().manual_seed(i)) for i, b in enumerate(batches)]
        runs[remat] = (losses, tr.model)
    (ln, mn), (lf, mf) = runs["none"], runs["full"]
    for a, b in zip(ln, lf):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (name, a), (_, b) in zip(mn.named_parameters(), mf.named_parameters()):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad), name
    for (name, a), (_, b) in zip(mn.named_buffers(), mf.named_buffers()):
        assert torch.equal(a, b), name


def test_remat_advances_bn_statistics_once(monkeypatch):
    """The recomputed forward in the backward leaves the running statistics
    alone: one advance per BN per step, to the plain step's values."""
    model = YOLOv10.create("yolov10n", class_names=NAMES, seed=3)
    n_bn = sum(isinstance(m, TL.BatchNorm) for m in model.modules())
    batch = _host_batches(1)[0]
    calls = []
    advance = TL.BatchNorm._advance
    monkeypatch.setattr(TL.BatchNorm, "_advance", lambda self, *a: (calls.append(self), advance(self, *a))[1])
    stats = {}
    for remat in ("none", "full"):
        calls.clear()
        tr = Trainer(copy.deepcopy(model), TrainConfig(remat=remat, augment=False), device="cpu")
        tr.forward_backward(batch)
        assert len(calls) == n_bn and len(set(map(id, calls))) == n_bn, remat
        stats[remat] = {k: v for k, v in tr.model.state_dict().items() if "running" in k}
    assert all(torch.equal(stats["none"][k], stats["full"][k]) for k in stats["none"])
    bn = model.backbone.cv0.bn
    assert not torch.equal(stats["full"]["backbone.cv0.bn.running_mean"], bn.running_mean)


def test_segments_keep_fewer_activations_and_the_same_outputs():
    """With `remat=True` the graph keeps only what lies outside the
    checkpoint segments (their inputs and the loss side); the outputs are
    the plain forward's, and without autograd a segment is a plain call."""
    model = YOLOv10.create("yolov10n", class_names=NAMES, seed=4).train()
    x = torch.from_numpy(_host_batches(1)[0].images).float()

    def forward_keeping(on: bool):
        kept = []

        def pack(t):
            kept.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = model(x, concat_head=False, remat=on)
        return out, sum(kept)

    plain, plain_bytes = forward_keeping(False)
    ckpt, ckpt_bytes = forward_keeping(True)
    with torch.no_grad():
        nograd = model(x, concat_head=False, remat=True)
    for k in plain:
        for (rp, cp), (rc, cc), (rn, cn) in zip(plain[k], ckpt[k], nograd[k]):
            assert torch.equal(rp, rc) and torch.equal(cp, cc) and torch.equal(rp, rn) and torch.equal(cp, cn)
    assert ckpt_bytes < 0.2 * plain_bytes, (ckpt_bytes, plain_bytes)


def test_device_preprocess_at_the_letterbox_size_equals_host(tmp_path):
    """Images already 96x96: the warp is a copy, so the device step gives
    the host step's losses (JAX's test_train_step_device_preprocess_loss_
    parity_identity)."""
    img_dir, ann = make_mixed_coco(str(tmp_path / "square"), n_images=2, sizes=((S, S),))
    model = YOLOv10.create("yolov10n", class_names=NAMES, seed=5)
    losses = {}
    for mode in ("host", "device"):
        batch = next(iter(DataLoader(CocoDetection(img_dir, ann, img_size=S, preprocess=mode), batch_size=2,
                                     max_boxes=8, workers=1)))
        tr = Trainer(copy.deepcopy(model), TrainConfig(device_preprocess=mode == "device", imgsz=S), device="cpu")
        losses[mode] = tr.train_step(batch)
    for k in ("total", "cls", "reg"):
        assert abs(float(losses["device"][k]) - float(losses["host"][k])) <= 1e-5 * abs(float(losses["host"][k]))


def test_batch_preprocess_mismatch_raises(mixed):
    """A batch of the other preprocess mode, or a DeviceBatch whose geometry
    was made for another letterbox size than TrainConfig.imgsz, raises."""
    img_dir, ann = mixed
    dev = next(iter(DataLoader(CocoDetection(img_dir, ann, img_size=64, preprocess="device"), batch_size=2,
                               max_boxes=4, workers=1)))
    assert dev.img_size == 64
    host = _host_batches(1)[0]
    model = YOLOv10.create("yolov10n", class_names=NAMES)
    for device_preprocess, imgsz, batch in ((True, 64, host), (False, 64, dev), (True, 96, dev)):
        tr = Trainer(model, TrainConfig(device_preprocess=device_preprocess, imgsz=imgsz), device="cpu")
        with pytest.raises(ValueError, match="batch/preprocess mismatch"):
            tr.train_step(batch)


def test_reset_head_matches_jax_head_init_structure_and_bounds():
    """A fresh head: every leaf drawn anew, the one2one branches exact
    copies (not aliases) of the one2many ones, JAX `head_init`'s leaf paths
    and shapes, conv weights within the kaiming bound sqrt(3 / fan_in),
    biases within 1 / sqrt(fan_in), BN at scale 1, bias 0, mean 0, var 1."""
    model = YOLOv10.create("yolov10n", class_names=NAMES, seed=0)
    cfg = model.cfg
    ref = jhead_init(jax.random.PRNGKey(1), NC, cfg.neck_out, cfg.reg_max)
    head = Head(NC, cfg.neck_out, cfg.reg_max, generator=torch.Generator().manual_seed(1))
    holder = copy.deepcopy(model)
    holder.head = head
    got = {path[1:]: a for path, a in flatten_param_paths(export_jax_params(holder)) if path[0] == "head"}
    want = dict(flatten_param_paths(ref))
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].shape == np.asarray(a).shape, path
        leaf = got[path]
        if path[-1] == "w":
            fan_in = np.prod(leaf.shape[:3])
            assert np.abs(leaf).max() <= np.sqrt(3.0 / fan_in) and np.abs(np.asarray(a)).max() <= np.sqrt(3.0 / fan_in)
        elif path[-1] == "b":
            fan_in = np.prod(got[path[:-1] + ("w",)].shape[:3])
            assert np.abs(leaf).max() <= 1.0 / np.sqrt(fan_in)
        else:
            np.testing.assert_array_equal(leaf, np.asarray(a))  # BN: scale 1, bias 0, mean 0, var 1
    for one2many, one2one in (("cv2", "one2one_cv2"), ("cv3", "one2one_cv3")):
        for (na, a), (_, b) in zip(getattr(head, one2many).state_dict().items(),
                                   getattr(head, one2one).state_dict().items()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), na
    old = dict(model.head.named_parameters())
    reset_head(model, seed=0)
    for name, p in model.head.named_parameters():
        if float(p.detach().std()) > 0:  # a drawn leaf, not a BN constant
            assert not torch.equal(p, old[name]), name
        assert torch.equal(p, dict(head.named_parameters())[name])  # seed + 1: the head drawn above
