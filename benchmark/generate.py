"""Inputs made from the seed: the weights, the images, the GT boxes and the
sample of requests that a serving run checks. The one general generator that every traffic mix
(`traffic/<mix>.json`, a file of parameters) goes through.

Everything is drawn on the run's device with a `torch.Generator` seeded from
`--seed`, in a few large calls. What sets the amount of work (the number of
GT boxes an image and their sizes) is drawn once from the mix's own
`shape_seed`, and `--seed` only deals it out to other images in another
order, so every seed asks for the same work.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .reference.model import YOLOv10 as RefModel
from .reference.model import init_scale

# Streams of one seed, kept apart so that adding a draw to one leaves the others as they were.
STREAM_WEIGHTS, STREAM_IMAGES, STREAM_GT, STREAM_AUGMENT, STREAM_SAMPLE = range(5)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on `device` for one stream of `seed` (any whole
    number that fits in 64 bits)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def make_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights from the seed, named as both the system's module
    tree and the reference's: one normal draw for every parameter,
    scaled leaf by leaf by `init_scale` (one multiply-add over the whole
    draw); running statistics 0 and 1 (`calibrate_state` sets them);
    the input normalization 0 and 255."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in RefModel(cfg).state_dict().items()}
    drawn = [k for k in shapes if not (k.endswith("running_mean") or k.endswith("running_var") or k.startswith("input_"))]
    sizes = [math.prod(shapes[k]) for k in drawn]
    stats = [init_scale(k, shapes[k]) for k in drawn]
    counts = torch.tensor(sizes, device=device)
    mean = torch.repeat_interleave(torch.tensor([m for m, _ in stats], device=device), counts)
    std = torch.repeat_interleave(torch.tensor([s for _, s in stats], device=device), counts)
    z = torch.randn(sum(sizes), generator=generator(seed, STREAM_WEIGHTS, device), device=device)
    flat = torch.addcmul(mean, z, std)
    state = dict(zip(drawn, (t.view(shapes[k]) for t, k in zip(flat.split(sizes), drawn))))
    for k, shp in shapes.items():
        if k.endswith("running_mean") or k == "input_subtract":
            state[k] = torch.zeros(shp, device=device)
        elif k.endswith("running_var"):
            state[k] = torch.ones(shp, device=device)
        elif k == "input_divide":
            state[k] = torch.full(shp, 255.0, device=device)
    return {k: state[k] for k in shapes}


def calibrate_state(cfg: dict, state: Dict[str, torch.Tensor], images: torch.Tensor) -> None:
    """Set every BN's running statistics in `state` to the batch statistics
    of `images` in the plain reference model (fp32, layer by layer), so
    served features keep a unit scale through the network as a trained
    model's do."""
    ref = RefModel(cfg).to(images.device)
    ref.load_state_dict(state)
    ref.eval().calibrate(images)
    for k, v in ref.state_dict().items():
        if k.endswith("running_mean") or k.endswith("running_var"):
            state[k].copy_(v)
    del ref


def make_images(n: int, size: int, params: dict, gen: torch.Generator, device) -> torch.Tensor:
    """uint8 NHWC [n, size, size, 3]: uniform colours on a coarse grid
    (`coarse` cells a side) upsampled bilinearly, plus Gaussian pixel noise
    (`noise_std`), clamped: full-range images with regions and edges."""
    coarse = int(params["coarse"])
    low = torch.rand(n, 3, coarse, coarse, generator=gen, device=device) * 255.0
    img = torch.nn.functional.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
    img = img + torch.randn(img.shape, generator=gen, device=device) * float(params["noise_std"])
    return img.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def gt_shapes(gt: dict, images: int) -> List[np.ndarray]:
    """The work the GT asks for, the same for every seed (drawn from the
    mix's `shape_seed`): per image slot, an array [count, 2] of box (w, h)
    in pixels. Count: 1 + a geometric draw of mean `count_mean` - 1, at most
    `count_max`; sides: sqrt-area log-uniform on `side_px`, aspect ratio
    log-uniform on `aspect`."""
    rng = np.random.default_rng(int(gt["shape_seed"]))
    counts = np.minimum(rng.geometric(1.0 / float(gt["count_mean"]), images), int(gt["count_max"]))
    lo, hi = (math.log(v) for v in gt["side_px"])
    alo, ahi = (math.log(v) for v in gt["aspect"])
    out = []
    for c in counts:
        side = np.exp(rng.uniform(lo, hi, c))
        ar = np.exp(rng.uniform(alo, ahi, c))
        out.append(np.stack([side * np.sqrt(ar), side / np.sqrt(ar)], -1).astype(np.float32))
    return out


def make_gt(gt: dict, batches: int, batch: int, imgsz: int, seed: int, nc: int):
    """GT of `batches` batches: a list of (labels int32 [B, S], boxes xyxy
    float32 [B, S, 4], mask bool [B, S]) on the host, S = `count_max`.
    Every batch holds the same multiset of box counts and sizes (from
    `gt_shapes`, dealt to its images in an order drawn from the seed), at
    positions and of classes drawn from the seed, each box inside the image."""
    shapes = gt_shapes(gt, batch)
    slots = int(gt["count_max"])
    rng = np.random.default_rng([int(seed) % (1 << 64), STREAM_GT])
    out = []
    for _ in range(batches):
        labels = np.zeros((batch, slots), np.int32)
        boxes = np.zeros((batch, slots, 4), np.float32)
        mask = np.zeros((batch, slots), bool)
        for i, j in enumerate(rng.permutation(batch)):
            wh = np.minimum(shapes[j], imgsz - 1)
            c = len(wh)
            x1 = rng.uniform(0, imgsz - wh[:, 0])
            y1 = rng.uniform(0, imgsz - wh[:, 1])
            boxes[i, :c] = np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], -1)
            labels[i, :c] = rng.integers(0, nc, c)
            mask[i, :c] = True
        out.append((labels, boxes, mask))
    return out


def serve_pool(mix: dict, cfg: dict, seed: int, device) -> torch.Tensor:
    """The serving mix's pool of distinct batches, uint8 [pool, B, S, S, 3] on the device."""
    gen = generator(seed, STREAM_IMAGES, device)
    n, b, s = int(mix["pool"]), int(mix["batch"]), int(mix.get("imgsz", cfg["imgsz"]))
    return make_images(n * b, s, mix["image"], gen, device).view(n, b, s, s, 3)


def train_pool(mix: dict, cfg: dict, seed: int, device) -> List[SimpleNamespace]:
    """The training mix's pool: batches with images on the device and the GT
    on the host (the trainer picks its GT bucket from the host mask)."""
    gen = generator(seed, STREAM_IMAGES, device)
    n, b, s = int(mix["pool"]), int(mix["batch"]), int(mix.get("imgsz", cfg["imgsz"]))
    images = make_images(n * b, s, mix["image"], gen, device).view(n, b, s, s, 3)
    gts = make_gt(mix["gt"], n, b, s, seed, cfg["nc"])
    return [SimpleNamespace(images=images[i], gt_labels=torch.from_numpy(l), gt_boxes=torch.from_numpy(bx),
                            gt_mask=torch.from_numpy(m)) for i, (l, bx, m) in enumerate(gts)]


class Reservoir:
    """k of a window's requests drawn from the seed, uniformly over however
    many the window finishes (reservoir sampling): `offer(n)`, for requests
    n = 0, 1, 2, ... in turn, gives the slot of k that request n takes, or
    None."""

    def __init__(self, seed: int, k: int) -> None:
        self.rng = np.random.default_rng([int(seed) % (1 << 64), STREAM_SAMPLE])
        self.k = int(k)

    def offer(self, n: int) -> Optional[int]:
        if n < self.k:
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k else None


def augment_uniforms(gen: torch.Generator, batch: int) -> Sequence[torch.Tensor]:
    """The four draws of `batch` uniforms an augmented step takes (flip,
    jitter, alpha, beta), in the order the step draws them."""
    return [torch.rand(batch, generator=gen, device=gen.device) for _ in range(4)]
