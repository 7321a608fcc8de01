"""The port's training slice (engine/trainer.py, batch-stat BN, the loss)
against the JAX trainer, on yolov10n, batch 2, fp32, on the CPU.

Input size: 96 px. At 64 px the P5 maps are 2x2, so the batch statistics of
the deepest BNs are taken over 8 values, some with variances near BN's eps;
dividing by them amplifies the two frameworks' different fp32 summation
orders about a thousandfold (measured: gradients 4.6e-3 of their scale
apart). At 96 px (18 values) the same checks hold with room.

Tolerances, each against the JAX package:
- train-mode head maps and BN batch statistics: 5e-4 of max(1, scale);
- every parameter's gradient: 1e-3 of that tensor's max|g|. Tensors whose
  gradient is zero up to rounding (a BN bias feeding straight into another
  batch-stat BN, whose normalization removes it) have no scale to hold to:
  both sides must keep them below 1e-4 of the largest gradient;
- the optimizer fed the same gradients as optax (per-group clip, AdamW,
  schedule), two steps: 1e-6 of each tensor's max|p|;
- three whole train steps at lr 1e-4: losses within 1e-4 relative, BN
  running statistics within 5e-4 of max(1, scale). Not parameters: on
  Adam's first step a gradient at rounding noise can flip sign and move a
  weight by 2 lr, so whole steps are held through what they compute. At
  lr 1e-3 this random net is unstable (its loss goes 1493 -> 2680 -> 1454)
  and those flips grow tenfold a step (measured gaps 1e-5, 2.7e-4, 5.9e-2
  over steps 2-4); at 1e-4 the loss falls steadily and the gaps stay under
  1e-5 for five steps.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.data.dataset import Batch
from leanyolo_tpu.engine import trainer as JTr
from leanyolo_tpu.models.yolov10.layers import BNStats, merge_bn_stats
from leanyolo_tpu.models.yolov10.losses import detection_loss_v10 as jax_loss
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10, model_apply
from leanyolo_tpu_torch import TrainConfig, Trainer, YOLOv10
from leanyolo_tpu_torch.data.dataset import DeviceBatch
from leanyolo_tpu_torch.engine import trainer as TTr
from leanyolo_tpu_torch.models.yolov10.convert import (
    export_jax_params,
    flatten_param_paths,
    load_jax_params,
    path_to_torch_key,
)
from leanyolo_tpu_torch.models.yolov10.layers import BatchNorm
from torch_parity import randomize_bn

S, B, N, NC = 96, 2, 6, 4
CFG = dict(augment=False, grad_clip=1.0, steps_per_epoch=1000)


def _batch(seed: int, s: int = S) -> Batch:
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(0, s - 26, (2, B, N))
    wh = rng.uniform(6, 24, (2, B, N))
    boxes = np.stack([x1, y1, x1 + wh[0], y1 + wh[1]], axis=-1).astype(np.float32)
    mask = rng.uniform(size=(B, N)) < 0.7
    mask[:, 0] = True
    return Batch(rng.randint(0, 256, (B, s, s, 3)).astype(np.uint8), rng.randint(0, NC, (B, N)).astype(np.int32),
                 boxes, mask, [None] * B)


@pytest.fixture(scope="module")
def setup():
    jm = JYOLOv10.create("yolov10n", class_names=[f"c{i}" for i in range(NC)], seed=0)
    params = randomize_bn(jm.params, np.random.RandomState(0))
    return jm.cfg, params, _batch(1)


def _port(params, train: bool = True) -> YOLOv10:
    return load_jax_params(YOLOv10.create("yolov10n", class_names=[f"c{i}" for i in range(NC)]), params).train(train)


def _jax_loss_fn(cfg, batch):
    def loss_fn(params):
        stats = BNStats()
        raw = model_apply(params, jnp.asarray(batch.images, jnp.float32), cfg, train=True, stats=stats,
                          concat_head=False)
        losses = jax_loss(raw, jnp.asarray(batch.gt_labels), jnp.asarray(batch.gt_boxes), jnp.asarray(batch.gt_mask),
                          num_classes=NC)
        return losses["total"], (raw, stats.updates)

    return loss_fn


@pytest.fixture(scope="module")
def jax_grads(setup):
    cfg, params, batch = setup
    (loss, (raw, stats)), grads = jax.jit(jax.value_and_grad(_jax_loss_fn(cfg, batch), has_aux=True))(params)
    return float(loss), raw, stats, grads


def _torch_grad_of(path, named):
    key = path_to_torch_key(path)
    return None if key not in named else named[key]


def test_train_forward_maps_and_bn_batch_stats(setup, jax_grads):
    cfg, params, batch = setup
    _, jraw, jstats, _ = jax_grads
    model = _port(params)
    for m in model.modules():
        if isinstance(m, BatchNorm):  # running <- 0.03 * batch statistic
            m.running_mean.zero_()
            m.running_var.zero_()
    with torch.no_grad():
        traw = model(torch.from_numpy(batch.images), dtype=torch.float32, concat_head=False)
    for branch in ("one2many", "one2one"):
        for jl, tl in zip(jraw[branch], traw[branch]):
            for j, t in zip(jl, tl):
                j = np.asarray(j)
                assert np.max(np.abs(t.numpy() - j)) <= 5e-4 * max(1.0, np.max(np.abs(j)))
    modules = dict(model.named_modules())
    assert len(jstats) == sum(isinstance(m, BatchNorm) for m in model.modules())
    for scope, upd in jstats.items():
        bn = modules[scope.replace("/", ".") + ".bn"]
        for name, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
            ref = np.asarray(upd[name])
            got = buf.numpy() / 0.03
            assert np.max(np.abs(got - ref)) <= 5e-4 * max(1.0, np.max(np.abs(ref))), (scope, name)


def test_grads_match_jax(setup, jax_grads):
    cfg, params, batch = setup
    jloss, _, _, grads = jax_grads
    model = _port(params)
    tr = Trainer(model, TrainConfig(**CFG), device="cpu")
    losses = tr.forward_backward(batch)
    assert abs(float(losses["total"]) - jloss) <= 1e-5 * abs(jloss)
    named = dict(model.named_parameters())
    pairs = []
    for path, g in flatten_param_paths(grads):
        p = _torch_grad_of(path, named)
        if p is None:
            continue  # BN running statistics and normalization buffers: never optimized
        g = np.asarray(g)
        pairs.append((path, g.transpose(3, 2, 0, 1) if g.ndim == 4 else g, p.grad.numpy()))
    assert len(pairs) == len(named)
    gmax = max(np.max(np.abs(g)) for _, g, _ in pairs)
    for path, ref, got in pairs:
        scale = np.max(np.abs(ref))
        if scale <= 1e-4 * gmax:
            assert np.max(np.abs(got)) <= 1e-4 * gmax, path
        else:
            assert np.max(np.abs(got - ref)) <= 1e-3 * scale, path


def test_optimizer_matches_optax_on_the_same_grads(setup, jax_grads):
    """Per-group clip by its own norm, AdamW with decay on every parameter,
    the warmup schedule: two steps fed JAX's gradients on both sides."""
    _, params, _ = setup
    grads = jax_grads[3]
    cfg = TrainConfig(**CFG)
    tx, _ = JTr.make_optimizer(params, JTr.TrainConfig(**CFG))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    tr = Trainer(_port(params), cfg, device="cpu")
    named = dict(tr.model.named_parameters())
    for _ in range(2):
        updates, state = tx.update(grads, state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        for path, g in flatten_param_paths(grads):
            p = _torch_grad_of(path, named)
            if p is not None:
                g = np.asarray(g)
                p.grad = torch.from_numpy(np.array(g.transpose(3, 2, 0, 1) if g.ndim == 4 else g))
        tr.optimizer_step()
        tr.global_step += 1
    got = dict(flatten_param_paths(export_jax_params(tr.model)))
    moved = 0
    for path, ref in flatten_param_paths(jp):
        ref = np.asarray(ref)
        assert np.max(np.abs(got[path] - ref)) <= 1e-6 * max(1e-3, np.max(np.abs(ref))), path
        moved += not np.array_equal(ref, np.asarray(dict(flatten_param_paths(params))[path]))
    assert moved > 200


def test_three_train_steps_match_jax(setup):
    cfg, params, batch = setup
    jm = JYOLOv10(cfg=cfg, class_names=[f"c{i}" for i in range(NC)],
                  params=jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), params))
    cfg3 = dict(CFG, lr=1e-4)
    jt = JTr.Trainer(jm, JTr.TrainConfig(**cfg3))
    tt = Trainer(_port(params), TrainConfig(**cfg3), device="cpu")
    for i in range(3):
        jl = jt.train_step(batch, jax.random.PRNGKey(i))
        tl = tt.train_step(batch)
        for k in ("total", "cls", "reg"):
            assert abs(float(tl[k]) - float(jl[k])) <= 1e-4 * abs(float(jl[k])), (i, k)
    got = dict(flatten_param_paths(export_jax_params(tt.model)))
    n = 0
    for path, ref in flatten_param_paths(jm.params):
        if path[-1] in ("mean", "var"):
            ref = np.asarray(ref)
            assert np.max(np.abs(got[path] - ref)) <= 5e-4 * max(1.0, np.max(np.abs(ref))), path
            n += 1
    assert n == 2 * sum(isinstance(m, BatchNorm) for m in tt.model.modules())


def test_bn_running_stats_merge_as_jax():
    """One training forward advances the running statistics exactly as
    JAX's merge_bn_stats does with the recorded batch statistics."""
    from leanyolo_tpu.models.yolov10 import layers as JL
    from leanyolo_tpu_torch.models.yolov10 import layers as TL

    rng = np.random.RandomState(2)
    params = randomize_bn(JL.cba_init(jax.random.PRNGKey(2), 8, 16, 3), rng)
    x = rng.randn(3, 6, 6, 8).astype(np.float32)
    stats = BNStats()
    JL.cba_apply(params, jnp.asarray(x), train=True, stats=stats, scope="blk")
    ref = merge_bn_stats({"blk": params}, stats)["blk"]["bn"]
    module = load_jax_params(TL.ConvBNAct(8, 16, 3), params).train()
    module(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, buf in (("mean", module.bn.running_mean), ("var", module.bn.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(ref[name]), rtol=1e-6, atol=1e-6)


def test_label_params_match_jax(setup):
    _, params, _ = setup
    labels = TTr.label_params(_port(params))
    buffers = dict(_port(params).named_buffers())
    for path, lbl in flatten_param_paths(JTr.label_params(params)):
        key = path_to_torch_key(path)
        if lbl == "stats":
            assert key in buffers  # never optimized: a buffer, not a parameter
        else:
            assert labels[key] == lbl, key
    opt, _ = TTr.make_optimizer(_port(params), TrainConfig())
    assert [g["name"] for g in opt.param_groups] == ["head", "backbone"]
    assert sum(len(g["params"]) for g in opt.param_groups) == len(labels)


@pytest.mark.parametrize("epochs,warmup,spe", [(10, 1, 3), (5, 2, 2), (4, 0, 1)])
def test_warmup_cosine_schedule_matches_jax(epochs, warmup, spe):
    ref = JTr.warmup_cosine_schedule(1e-3, epochs=epochs, warmup_epochs=warmup, steps_per_epoch=spe)
    got = TTr.warmup_cosine_schedule(1e-3, epochs=epochs, warmup_epochs=warmup, steps_per_epoch=spe)
    for step in range(epochs * spe + 2):
        assert abs(got(step) - float(ref(step))) <= 1e-7 * 1e-3, step


def test_augment_flip_exact_against_jax():
    batch = _batch(3, s=32)
    kw = dict(p_hflip=1.0, p_bc=0.0)
    ji, jb = JTr.augment_batch(jax.random.PRNGKey(0), jnp.asarray(batch.images), jnp.asarray(batch.gt_boxes),
                               dtype=jnp.float32, **kw)
    ti, tb = TTr.augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(batch.images),
                               torch.from_numpy(batch.gt_boxes), dtype=torch.float32, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ti.numpy(), batch.images[:, :, ::-1].astype(np.float32))


def test_augment_jitter_uses_the_generator_draws():
    imgs = torch.from_numpy(_batch(4, s=16).images)
    boxes = torch.zeros(B, 1, 4)
    out, ob = TTr.augment_batch(torch.Generator().manual_seed(7), imgs, boxes, p_hflip=0.0, p_bc=1.0,
                                dtype=torch.float32)
    u = [torch.rand(B, generator=g) for g in [torch.Generator().manual_seed(7)] for _ in range(4)]
    alpha, beta = 0.8 + 0.4 * u[2], u[3] * 32.0 - 16.0
    ref = torch.clamp(imgs.float() * alpha[:, None, None, None] + beta[:, None, None, None], 0.0, 255.0)
    assert torch.equal(out, ref) and torch.equal(ob, boxes)
    with pytest.raises(ValueError, match="dtype"):
        TTr.augment_batch(torch.Generator(), imgs, boxes, p_hflip=0.5, p_bc=0.5)


def test_frozen_backbone_keeps_moments_cold():
    """Counterpart of tests/test_training_quality.py::test_frozen_backbone_
    keeps_moments_cold: while frozen, backbone+neck parameters get no
    gradient, no decay and no Adam state, the head trains, and the schedule
    advances; at the unfreeze epoch they join with a fresh step count."""
    model = YOLOv10.create("yolov10n", class_names=["a", "b"], seed=0)
    cfg = TrainConfig(epochs=4, steps_per_epoch=1, freeze_backbone=True, unfreeze_epoch=2, augment=False,
                      grad_clip=0.0, lr=1e-2)
    tr = Trainer(model, cfg, device="cpu")
    rng = np.random.RandomState(0)
    batch = Batch(rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32), np.zeros((2, 4), np.int32),
                  np.tile(np.asarray([4, 4, 30, 30], np.float32), (2, 4, 1)),
                  np.concatenate([np.ones((2, 1), bool), np.zeros((2, 3), bool)], axis=1), [None] * 2)
    w0 = model.backbone.cv0.conv.weight
    neck_w = model.neck.p3_down.conv.weight
    w0_before, neck_before = w0.detach().clone(), neck_w.detach().clone()
    head_before = model.head.cv2[0][2].weight.detach().clone()

    tr.train_step(batch)
    tr.train_step(batch)  # epochs 0 and 1: frozen
    assert torch.equal(w0, w0_before) and torch.equal(neck_w, neck_before)
    assert w0.grad is None
    assert float((model.head.cv2[0][2].weight.detach() - head_before).abs().max()) > 0
    assert w0 not in tr.opt.state and neck_w not in tr.opt.state  # no moments, no step count
    bb_group = next(g for g in tr.opt.param_groups if g["name"] == "backbone")
    assert bb_group["lr"] == tr.schedules["backbone"](1)  # the schedule kept moving

    tr.train_step(batch)  # epoch 2: unfrozen
    assert float((w0.detach() - w0_before).abs().max()) > 0
    assert int(tr.opt.state[w0]["step"]) == 1
    assert int(tr.opt.state[model.head.cv2[0][2].weight]["step"]) == 3


def test_resume_reproduces_the_run_bit_for_bit(tmp_path):
    cfg = TrainConfig(augment=True, grad_clip=1.0, steps_per_epoch=2, epochs=3, lr=1e-3)
    batches = [_batch(10 + i, s=64) for i in range(4)]
    gen = lambda i: torch.Generator().manual_seed(100 + i)

    whole = Trainer(YOLOv10.create("yolov10n", class_names=["a", "b", "c", "d"], seed=1), cfg, device="cpu")
    losses = [float(whole.train_step(b, gen(i))["total"]) for i, b in enumerate(batches)]

    first = Trainer(YOLOv10.create("yolov10n", class_names=["a", "b", "c", "d"], seed=1), cfg, device="cpu")
    for i in range(2):
        first.train_step(batches[i], gen(i))
    path = str(tmp_path / "state.pt")
    first.save_train_state(path)
    resumed = Trainer(YOLOv10.create("yolov10n", class_names=["a", "b", "c", "d"], seed=5), cfg, device="cpu")
    resumed.load_train_state(path)
    assert resumed.global_step == 2
    again = [float(resumed.train_step(batches[i], gen(i))["total"]) for i in (2, 3)]
    assert again == losses[2:]
    for (k, a), (_, b) in zip(whole.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), k


def test_nmax_bucket_slices_the_gt_arrays():
    tr = Trainer(YOLOv10.create("yolov10n", class_names=["a"]), TrainConfig(), device="cpu")
    mask = np.zeros((2, 128), bool)
    mask[0, :11] = True
    assert tr._nmax_bucket(mask) == 16
    assert tr._nmax_bucket(torch.from_numpy(mask)) == 16
    assert tr._nmax_bucket(np.zeros((2, 24), bool)) == 8
    assert tr._nmax_bucket(np.ones((2, 24), bool)) == 24


def test_trainer_device_and_unported_options():
    """Without a card the trainer raises unless asked for the CPU; device
    letterboxing and activation checkpointing construct and step on the CPU
    (their parity with JAX: test_torch_train_device.py); `mesh=` of one
    process with no process group steps as the plain trainer (data
    parallelism: test_torch_parallel.py); unknown remat modes raise;
    augmentation needs a Generator."""
    model = YOLOv10.create("yolov10n", class_names=["a"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(model, TrainConfig())
    host = _batch(0, s=32)
    host.gt_labels[:] = 0  # one class
    rng = np.random.RandomState(1)
    device = DeviceBatch(rng.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8), np.asarray([[24, 32]] * B, np.int32),
                         np.asarray([[0, 4]] * B, np.int32), np.asarray([[48, 64]] * B, np.int32),
                         np.asarray([[0.5, 0.5, 0, 4]] * B, np.float32), host.gt_labels, host.gt_boxes * 2,
                         host.gt_mask, [None] * B, 32)
    for kw, batch in ((dict(device_preprocess=True, imgsz=32), device), (dict(remat="full"), host)):
        tr = Trainer(model, TrainConfig(augment=False, **kw), device="cpu")
        losses = tr.train_step(batch)
        assert tr.global_step == 1 and all(np.isfinite(float(v)) for v in losses.values()), kw
    one = SimpleNamespace(size=lambda: 1, ndim=1)
    plain = Trainer(copy.deepcopy(model), TrainConfig(augment=False), device="cpu").train_step(host)
    meshed = Trainer(copy.deepcopy(model), TrainConfig(augment=False), mesh=one, device="cpu").train_step(host)
    assert all(torch.equal(plain[k], meshed[k]) for k in plain)
    with pytest.raises(ValueError, match="remat"):
        Trainer(model, TrainConfig(remat="some"), device="cpu")
    tr = Trainer(model, TrainConfig(augment=True), device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        tr.train_step(host)


def test_export_inverts_load(setup):
    _, params, _ = setup
    model = _port(params)
    tree = export_jax_params(model)
    ref = dict(flatten_param_paths(params))
    got = dict(flatten_param_paths(tree))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32))
    again = load_jax_params(copy.deepcopy(model), tree)
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
