"""The serving cells: set-up, the closed-loop window, the traced stretch and
the check of what the window served.

A request is one batch of images handed to `Predictor.run_batch`. The
window keeps the mix's `in_flight` requests issued: it issues request n + 1
before it waits for request n, as a pipeline that keeps a batch queued
does. A request's detections (`dets`, `num`) are copied to pinned host
memory behind it, with an event recorded after the copy; its latency runs
from the host's call of `run_batch` to the host holding them (that event
waited on, read on the host's clock).
"""

from __future__ import annotations

import contextlib
import math
import sys
from collections import deque
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import generate as G
from .reference.model import YOLOv10 as RefModel
from .reference.model import dfl_boxes, flat_maps

SPANS = ("request", "forward", "decode", "readback")


@dataclass
class Served:
    """What one window did: per request its call and done times (seconds
    from the window's start) and the host seconds of its `run_batch` call;
    the window's length (its start to the last readback), and the
    detections of the sampled requests."""

    called: np.ndarray
    done: np.ndarray
    host_s: np.ndarray
    seconds: float
    kept: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    failed: int = 0


def setup(cfg: dict, mix: dict, seed: int, device: torch.device):
    """(predictor, pool, weights, readback ring): the weights drawn and their BN statistics
    calibrated on 8 images spread over the pool, loaded into the system's model,
    folded and cast by its Predictor, and every request shape warmed up."""
    from leanyolo_tpu_torch.engine.predictor import Predictor
    from leanyolo_tpu_torch.models.registry import get_model

    s = cfg["serve"]
    state = G.make_state(cfg, seed, device)
    pool = G.serve_pool(mix, cfg, seed, device)
    images = pool.flatten(0, 1)
    G.calibrate_state(cfg, state, images[:: max(1, images.shape[0] // 8)][:8])
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg["model"], weights=None, class_names=[f"class{i}" for i in range(cfg["nc"])])
    model.load_state_dict(state)
    pred = Predictor(model, imgsz=pool.shape[2], decode=s["decode"], conf_thresh=s["conf_thresh"],
                     max_det=s["max_det"], dtype=s["dtype"], fuse=s["fold"], device=device)
    del model
    pin = device.type == "cuda"
    ring = None
    for _ in range(2):  # every pool batch through the request's path and its readback, twice
        for i in range(pool.shape[0]):
            dets, num = pred.run_batch(pool[i])
            if ring is None:  # the pinned buffers the window copies into, made here and not inside it
                ring = [(torch.empty(dets.shape, pin_memory=pin), torch.empty(num.shape, dtype=num.dtype, pin_memory=pin))
                        for _ in range(int(mix["in_flight"]) + 1)]
            ring[i % len(ring)][0].copy_(dets)
            ring[i % len(ring)][1].copy_(num)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return pred, pool, state, ring


def window(pred, pool: torch.Tensor, ring: list, seconds: float, sample: Optional[G.Reservoir], *,
           spans: bool = False, max_requests: Optional[int] = None) -> Served:
    """Serve requests back to back for `seconds` (or `max_requests`),
    `len(ring) - 1` in flight: request n takes pool batch n mod pool size,
    its detections are copied into set-up's pinned `ring`, and request n +
    1 is issued before request n is waited for. Keeps the detections of the
    requests `sample` picks and of the last. With `spans` each request's
    parts run inside `record_function` spans for the profiler."""
    from torch.profiler import record_function

    cuda = pool.device.type == "cuda"
    n_pool, in_flight = pool.shape[0], len(ring) - 1
    called, done, host_s = [], [], []
    picked: Dict[int, Tuple[int, tuple]] = {}  # sample slot -> (request, detections)
    pending: deque = deque()  # (request, ring slot, event)
    failed = 0

    def span(name):
        return record_function(name) if spans else contextlib.nullcontext()

    def harvest() -> None:
        n, slot, ev = pending.popleft()
        if ev is not None:
            ev.synchronize()
        done[n] = time.perf_counter() - t0
        j = sample.offer(n) if sample is not None else None
        if j is not None:
            picked[j] = (n, (ring[slot][0].numpy().copy(), ring[slot][1].numpy().copy()))

    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds and (max_requests is None or n < max_requests):
        slot = n % len(ring)
        with span("request"):
            c0 = time.perf_counter()
            try:
                dets, num = pred.run_batch(pool[n % n_pool])
            except RuntimeError as e:  # a request that raises has failed; the window goes on
                print(f"request {n} failed: {e}", file=sys.stderr)
                failed += 1
                continue
            c1 = time.perf_counter()
            with span("readback"):
                ring[slot][0].copy_(dets, non_blocking=cuda)
                ring[slot][1].copy_(num, non_blocking=cuda)
                ev = torch.cuda.Event() if cuda else None
                if ev is not None:
                    ev.record()
        called.append(c0 - t0)
        host_s.append(c1 - c0)
        done.append(math.nan)
        pending.append((n, slot, ev))
        n += 1
        if len(pending) >= in_flight:  # request n is issued: wait for request n + 1 - in_flight
            harvest()
    while pending:
        harvest()
    out = Served(np.array(called), np.array(done), np.array(host_s), time.perf_counter() - t0, failed=failed)
    out.kept = dict(picked.values())
    if n:
        slot = (n - 1) % len(ring)
        out.kept[n - 1] = (ring[slot][0].numpy().copy(), ring[slot][1].numpy().copy())
    return out


def wrap_spans(pred) -> None:
    """Run the predictor's model forward (`raw`) and decode (`decode_raw`)
    inside spans, by wrapping the bound methods on the instance:
    `run_batch` still calls them, so the timed entry is unchanged."""
    from torch.profiler import record_function

    for attr, name in (("raw", "forward"), ("decode_raw", "decode")):
        fn = getattr(pred, attr)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            with record_function(_name):
                return _fn(*a, **kw)

        setattr(pred, attr, wrapped)


def end_to_end(served: Served, batch: int) -> Dict[str, float]:
    """serve_img_per_s: the images of every request, over the window (its
    start to the last readback); serve_p95_ms: the 95th percentile of every
    request's latency (call to readback); and the figures printed beside
    them."""
    lat = (served.done - served.called) * 1e3
    if not len(lat):
        return {"serve_img_per_s": 0.0, "serve_p95_ms": math.inf, "requests": 0, "host_call_ms": math.inf}
    return {
        "serve_img_per_s": len(lat) * batch / served.seconds,
        "serve_p95_ms": float(np.percentile(lat, 95)),
        "requests": len(lat), "window_s": served.seconds,
        "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
        "max_ms": float(lat.max()), "host_call_ms": float(served.host_s.mean() * 1e3),
    }


# -- the check ---------------------------------------------------------------


MATCH_TOP = 4  # a served detection is looked for among the reference's best MATCH_TOP * max_det pairs
MATCH_STRIDES = 4.0  # ... with a box within this many strides of the pair's level
LOGIT_CLIP = 16.0  # fp32 sigmoid rounds to 1 above about 16.6: logits are compared clipped to +-16


def _logits(scores: np.ndarray) -> np.ndarray:
    """The logits of fp32 sigmoid scores (clipped to +-LOGIT_CLIP)."""
    s = scores.astype(np.float64)
    with np.errstate(divide="ignore"):
        return np.clip(np.log(s) - np.log1p(-s), -LOGIT_CLIP, LOGIT_CLIP)


@torch.no_grad()
def reference_maps(cfg: dict, state: dict, images: torch.Tensor, quant: Optional[str] = None, chunk: int = 8):
    """The plain fp32 model's one2one maps of `images` as (class logits [B, A,
    nc], boxes [B, A, 4] xyxy pixels, each anchor's stride [A]), computed
    `chunk` images at a time."""
    ref = RefModel(cfg).to(images.device).eval().set_quant(quant)
    ref.load_state_dict(state)
    logits, boxes = [], []
    for i in range(0, images.shape[0], chunk):
        reg, cls, hw = flat_maps(ref(images[i:i + chunk], branches=("one2one",))["one2one"])
        logits.append(cls.float())
        boxes.append(dfl_boxes(reg, hw, cfg["strides"], cfg["reg_max"]))
    stride = torch.cat([torch.full((h * w,), float(s), device=images.device) for (h, w), s in zip(hw, cfg["strides"])])
    return torch.cat(logits), torch.cat(boxes), stride


def compare(dets: np.ndarray, num: np.ndarray, logits: torch.Tensor, boxes: torch.Tensor, stride: torch.Tensor, *,
            conf: float) -> Dict[str, float]:
    """One request's detections against the reference's maps of its images
    (logits clipped to +-LOGIT_CLIP, where fp32 sigmoid scores still tell
    them apart). Compared (COMPARED):

    logit_rms: the root mean square, over images and ranks, of the gap
    between the served detections' logits sorted and the reference's best
    (anchor, class) logits of the same ranks (a sorted list moves no more
    than its worst element, so near-ties that swap cost nothing).
    num_mismatch: images whose `num` is not their count of detections
    scored above `conf`.

    det_unmatched: the share of served detections with no pair of their
    own class among the reference's best MATCH_TOP * max_det (anchor,
    class) pairs whose box lies within MATCH_STRIDES strides of the
    detection's (the largest coordinate gap, in strides of the pair's
    level). A wrong class, or the box of another anchor, leaves a
    detection unmatched.

    Printed only: logit_max, the widest logit gap; box_gap_median and
    box_gap_p90, the matched detections' box gaps in strides."""
    dev = logits.device
    k = dets.shape[1]
    logits = logits.double().clamp(-LOGIT_CLIP, LOGIT_CLIP)
    served = torch.from_numpy(_logits(dets[..., 4])).to(dev)
    ref_top = torch.topk(logits.flatten(1), k, dim=1).values
    gap = (torch.sort(served, 1, descending=True).values - ref_top).abs().flatten()
    cls = torch.from_numpy(dets[..., 5].astype(np.int64)).to(dev)
    box = torch.from_numpy(dets[..., :4]).to(dev).double()
    top = torch.topk(logits.flatten(1), MATCH_TOP * k, dim=1).indices
    nc = logits.shape[2]
    ref_anchor, ref_cls = top // nc, top % nc
    box_gap = []
    for i in range(dets.shape[0]):
        a = ref_anchor[i]
        same = ref_cls[i][None] == cls[i][:, None]  # [k, MATCH_TOP k]
        dist = (boxes[i].double()[a][None] - box[i][:, None]).abs().amax(-1) / stride[a].double()[None]
        box_gap.append(torch.where(same, dist, torch.full_like(dist, math.inf)).amin(1))
    box_gap = torch.cat(box_gap)
    num_mismatch = int(np.sum(num != (dets[..., 4] > conf).sum(-1)))
    matched = box_gap[box_gap <= MATCH_STRIDES].float()
    return {"logit_rms": float(gap.pow(2).mean().sqrt()), "det_unmatched": float((~(box_gap <= MATCH_STRIDES)).double().mean()),
            "num_mismatch": float(num_mismatch), "logit_max": float(gap.max()),
            "box_gap_median": float(matched.median()) if len(matched) else math.inf,
            "box_gap_p90": float(torch.quantile(matched, 0.9)) if len(matched) else math.inf}


COMPARED = ("logit_rms", "det_unmatched", "num_mismatch")


def check(cfg: dict, state: dict, pool: torch.Tensor, kept: Dict[int, tuple],
          quant: Optional[str] = None) -> Dict[str, float]:
    """The widest of each number over the kept requests (request n served
    pool batch n mod pool size)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst: Dict[str, float] = {}
    n_pool = pool.shape[0]
    for p in sorted({n % n_pool for n in kept}):
        logits, boxes, stride = reference_maps(cfg, state, pool[p], quant)
        for n, (dets, num) in kept.items():
            if n % n_pool == p:
                got = compare(dets, num, logits, boxes, stride, conf=cfg["serve"]["conf_thresh"])
                worst = {key: max(worst.get(key, 0.0), v) for key, v in got.items()}
        del logits, boxes
    return worst


@torch.no_grad()
def control(cfg: dict, state: dict, pool: torch.Tensor, quant: str = "fp8") -> Dict[str, float]:
    """The control: the reference computed in the lower precision `quant`
    in the system's place, its own top-k decode judged as the system's is."""
    worst: Dict[str, float] = {}
    s = cfg["serve"]
    for p in range(pool.shape[0]):
        logits, boxes, stride = reference_maps(cfg, state, pool[p])
        qlog, qbox, _ = reference_maps(cfg, state, pool[p], quant)
        top = torch.topk(qlog.flatten(1), s["max_det"], dim=1)
        a, c = top.indices // qlog.shape[2], top.indices % qlog.shape[2]
        qb = torch.gather(qbox, 1, a[..., None].expand(-1, -1, 4))
        dets = torch.cat([qb, torch.sigmoid(top.values)[..., None], c[..., None].float()], -1).cpu().numpy()
        num = (dets[..., 4] > s["conf_thresh"]).sum(1).astype(np.int32)
        got = compare(dets, num, logits, boxes, stride, conf=s["conf_thresh"])
        worst = {key: max(worst.get(key, 0.0), v) for key, v in got.items()}
    return worst
