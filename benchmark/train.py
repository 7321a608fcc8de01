"""The training cells: set-up, the window of back-to-back steps, the traced
stretch and the check of the trainer's first steps.

Set-up builds one `Trainer` and drives it through its first steps (the
mix's `setup_steps`, on pool batches 0, 1, ...) with the window's own call
and feed; it reads the loss of each and the first gradient as AdamW holds
it after one step (exp_avg / (1 - beta1)). The same trainer then runs the
window, whose first step is the last one checked: its loss, and each
parameter's change from the weights once it has run. A step's loss is read
back once a step, which is its one synchronize.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from . import generate as G
from .reference import train as RT
from .reference.model import BatchNorm
from .reference.model import YOLOv10 as RefModel

SPANS = ("step", "forward_backward", "optimizer_step", "loss_readback")


@dataclass
class Readings:
    """Per-parameter norms and per-step losses of the first steps."""

    losses: List[float] = field(default_factory=list)
    grad: Dict[str, float] = field(default_factory=dict)
    change: Dict[str, float] = field(default_factory=dict)
    bn_var: Dict[str, torch.Tensor] = field(default_factory=dict)  # each BN's running variance after step 1


def train_config(cfg: dict):
    from leanyolo_tpu_torch.engine.trainer import TrainConfig

    t = cfg["train"]
    return TrainConfig(lr=t["lr"], weight_decay=t["weight_decay"], epochs=t["epochs"],
                       warmup_epochs=t["warmup_epochs"], bb_lr_mult=t["bb_lr_mult"], grad_clip=t["grad_clip"],
                       bf16=t["dtype"] == "bfloat16", augment=t["augment"], p_hflip=t["p_hflip"], p_bc=t["p_bc"],
                       steps_per_epoch=t["steps_per_epoch"], remat=t["remat"])


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in names]).cpu().tolist()
    return dict(zip(names, norms))


def _running_vars(model) -> Dict[str, torch.Tensor]:
    """Each BN's running variance (on the host), named by its module."""
    return {k[: -len(".running_var")]: v.detach().float().cpu().clone() for k, v in model.named_buffers()
            if k.endswith(".running_var")}


def setup(cfg: dict, mix: dict, seed: int, device: torch.device, breaker=None):
    """(trainer, pool, weights, readings, augmentation generator): the first
    steps run here, and they warm up every shape the window uses.
    `breaker(trainer)`, for the tests, breaks the timed path before them."""
    from leanyolo_tpu_torch.engine.trainer import Trainer
    from leanyolo_tpu_torch.models.registry import get_model

    state = G.make_state(cfg, seed, device)
    pool = G.train_pool(mix, cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg["model"], weights=None, class_names=[f"class{i}" for i in range(cfg["nc"])])
    model.load_state_dict(state)
    tr = Trainer(model, train_config(cfg), device=device)
    if breaker is not None:
        breaker(tr)
    gen = G.generator(seed, G.STREAM_AUGMENT, device)
    beta1 = cfg["train"]["betas"][0]
    r = Readings()
    for i in range(int(mix["setup_steps"])):
        losses = tr.train_step(pool[i % len(pool)], gen)
        r.losses.append(float(losses["total"]))
        if i == 0:
            r.grad = _norms({k: tr.opt.state[p].get("exp_avg", torch.zeros_like(p)) / (1 - beta1)
                             for k, p in tr.model.named_parameters()})
            r.bn_var = _running_vars(tr.model)
    return tr, pool, state, r, gen


@dataclass
class Trained:
    steps: int
    seconds: float
    host_s: List[float]
    losses: List[float]
    failed: int


def window(tr, pool, gen, start: int, seconds: float, *, spans: bool = False, max_steps: Optional[int] = None,
           check: Optional[tuple] = None) -> Trained:
    """Back-to-back steps on the pool's batches from batch `start` on, until
    the first step that ends `seconds` after the window's start (or
    `max_steps`); each step's loss read back before the next begins. With
    `check` = (set-up's readings, the initial weights), the first step's
    loss and each parameter's change once it has run join the readings."""
    from torch.profiler import record_function

    host, losses = [], []
    failed, k = 0, 0
    t0 = time.perf_counter()
    while True:
        batch = pool[(start + k) % len(pool)]
        with record_function("step") if spans else contextlib.nullcontext():
            c0 = time.perf_counter()
            out = tr.train_step(batch, gen)
            host.append(time.perf_counter() - c0)
            with record_function("loss_readback") if spans else contextlib.nullcontext():
                loss = float(out["total"])
        losses.append(loss)
        failed += not (loss == loss and abs(loss) != float("inf"))
        if check is not None and k == 0:
            readings, state = check
            readings.losses.append(loss)
            readings.change = _norms({n: p.detach() - state[n] for n, p in tr.model.named_parameters()})
        k += 1
        t = time.perf_counter() - t0
        if t >= seconds or (max_steps is not None and k >= max_steps):
            return Trained(k, t, host, losses, failed)


def wrap_spans(tr) -> None:
    """Run `forward_backward` and `optimizer_step` inside spans, wrapping the
    bound methods on the instance: `train_step` still calls them."""
    from torch.profiler import record_function

    for attr in ("forward_backward", "optimizer_step"):
        fn = getattr(tr, attr)

        def wrapped(*a, _fn=fn, _name=attr, **kw):
            with record_function(_name):
                return _fn(*a, **kw)

        setattr(tr, attr, wrapped)


# -- the check ---------------------------------------------------------------


def reference_readings(cfg: dict, mix: dict, state: Dict[str, torch.Tensor], pool, seed: int, steps: int,
                       quant: Optional[str] = None, half_batch: bool = False) -> Readings:
    """The plain fp32 reference's readings of the first `steps` steps, from
    the same weights, batches and augmentation draws (a fresh generator of
    the same seed); each node recomputed in the backward so that it fits.
    `quant` computes it in a lower precision (the control); `half_batch`
    takes the loss of the first half of each batch alone (a planted fault)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = state[next(iter(state))].device
    ref = RefModel(cfg).to(device).train().set_quant(quant)
    ref.load_state_dict(state)
    ref.checkpoint = device.type == "cuda"
    named = dict(ref.named_parameters())
    opt = RT.AdamW(named, cfg)
    gen = G.generator(seed, G.STREAM_AUGMENT, device)
    t = cfg["train"]
    r = Readings()
    for i in range(steps):
        batch = pool[i % len(pool)]
        u = G.augment_uniforms(gen, batch.images.shape[0])
        nb = RT.gt_bucket(batch.gt_mask)
        labels, boxes, mask = (x[:, :nb].to(device) for x in (batch.gt_labels, batch.gt_boxes, batch.gt_mask))
        images, boxes = RT.augment(batch.images, boxes, u, t["p_hflip"], t["p_bc"])
        if half_batch:
            h = images.shape[0] // 2
            images, labels, boxes, mask = images[:h], labels[:h], boxes[:h], mask[:h]
        for p in named.values():
            p.grad = None
        bns = {k: m for k, m in ref.named_modules() if isinstance(m, BatchNorm)}
        for m in bns.values():
            m.record = i == 0
        loss = RT.detection_loss(ref(images), labels, boxes, mask, cfg)
        loss.backward()
        opt.clip_()
        r.losses.append(float(loss.detach()))
        if i == 0:
            r.grad = _norms({k: p.grad for k, p in named.items()})
            # the running variance the system's step 1 leaves: (1 - m) + m var n / (n - 1)
            m = t["bn_momentum"]
            for k, bn in bns.items():
                cnt = bn.batch_count
                r.bn_var[k] = ((1 - m) + m * bn.batch_var * cnt / max(cnt - 1, 1)).cpu()
                bn.record, bn.batch_var = False, None
        opt.step()
    r.change = _norms({k: p.detach() - state[k] for k, p in named.items()})
    return r


def compare(got: Readings, ref: Readings, momentum: float, quiet: float = 1e-3) -> Dict[str, float]:
    """The numbers compared (COMPARED) and some printed beside them.

    loss_gap: the largest |loss - reference| / |reference| over the steps.
    change_gap: over the parameters, the gap between the system's norm of
    its change over the steps and the reference's, over the larger of the
    reference's norm of that parameter and the median parameter's; its
    median over the parameters. It leaves out the parameters whose
    reference gradient is under `quiet` times the median's (a BN bias
    before another BN: its gradient is rounding, and AdamW moves it by
    rounding alone). bn_var_gap: step 1's batch variances of each BN of
    the backbone's first nodes (EARLY; a vector over channels, worked back
    from the running variances the step leaves), the gap relative to the
    reference's; its median over those BNs.

    Printed only: grad_gap, the widest gap of the first gradient's norms
    (same measure), and grad_median, its median over the parameters;
    change_widest; bn_var_median and bn_var_widest over every BN. The
    widest gaps swing from seed to seed as single decisions of the
    assignment flip on rounding (a parameter whose gradient hangs on a few
    assigned anchors moves or not), and no control reads the medians three
    times higher than sound runs do."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses))
    g_med = statistics.median(ref.grad.values())
    c_med = statistics.median(ref.change.values())
    grad_gap = max(abs(got.grad[k] - v) / max(v, g_med) for k, v in ref.grad.items())
    moved = [k for k, v in ref.grad.items() if v >= quiet * g_med]
    change = [abs(got.change[k] - ref.change[k]) / max(ref.change[k], c_med) for k in moved]
    bn = bn_gaps(got, ref, momentum)
    early = [g for k, g in zip(ref.bn_var, bn) if k.split(".")[:2] in EARLY]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": statistics.median(change),
            "bn_var_gap": statistics.median(early), "bn_var_median": statistics.median(bn), "bn_var_widest": max(bn),
            "change_widest": max(change), "grad_median": statistics.median(
                abs(got.grad[k] - v) / max(v, g_med) for k, v in ref.grad.items())}


COMPARED = ("loss_gap", "change_gap", "bn_var_gap")
# The BNs of the backbone's first nodes, up to stride 8, whose batch statistics bn_var_gap compares:
# deeper, a random network's rounding has grown until every precision reads alike.
EARLY = [["backbone", n] for n in ("cv0", "cv1", "c2", "cv3", "c4")]


def bn_gaps(got: Readings, ref: Readings, momentum: float) -> List[float]:
    """Per BN, in the forward's order: the gap of step 1's batch variances
    (a vector over channels), relative to the reference's; worked back from
    the running variances the step leaves, (var - (1 - m)) / m."""
    return [float((got.bn_var[k] - v).norm() / (v - (1 - momentum)).norm()) for k, v in ref.bn_var.items()]


def worst_leaves(got: Readings, ref: Readings, n: int = 4) -> str:
    """The parameters of the widest gradient and change gaps, with both
    norms and the median's (for the run's standard error)."""
    g_med = statistics.median(ref.grad.values())
    c_med = statistics.median(ref.change.values())
    rows = []
    for what, a, b, med in (("grad", got.grad, ref.grad, g_med), ("change", got.change, ref.change, c_med)):
        top = sorted(b, key=lambda k: -abs(a[k] - b[k]) / max(b[k], med))[:n]
        rows.append(f"{what} (median {med:.4g}): " + ", ".join(
            f"{k} {a[k]:.4g}/{b[k]:.4g} (ref grad {ref.grad[k] / g_med:.3g} x median)" for k in top))
    return "; ".join(rows)
