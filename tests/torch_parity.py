"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU (tests/conftest.py) and the port runs on the CPU too, where each
kernel wrapper takes its plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the tier-1 run uses several pytest workers


def randomize_bn(tree, rng: np.random.RandomState):
    """A copy of a JAX params tree with non-trivial BN statistics, so that
    folding is exercised (fresh init has scale 1, bias 0, mean 0, var 1)."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = np.asarray(tree["scale"]).shape
            return {
                "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (rng.randn(*c) * 0.1).astype(np.float32),
                "mean": (rng.randn(*c) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
            }
        return {k: randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [randomize_bn(v, rng) for v in tree]
    return np.asarray(tree)


def nhwc_to_torch(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> NCHW torch (the port's block layout)."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).to(dtype)


def torch_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def as_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32) if not torch.is_tensor(x) else x.detach().float().numpy()


def bf16_ulps(ref: np.ndarray, n: float) -> float:
    """n bf16 ulps (2^-8 relative) of the largest magnitude in `ref` (at least 1)."""
    return n * 2.0 ** -8 * max(1.0, float(np.max(np.abs(ref))))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


MIXED_SIZES = ((72, 96), (96, 64), (100, 100), (48, 80), (120, 90))


def make_mixed_coco(root, *, n_images: int = 10, sizes=MIXED_SIZES, seed: int = 0, noise=(90, 130)):
    """A learnable COCO-format set at mixed image sizes (`make_learnable_coco`'s
    classes: a red rectangle, a green circle and a blue triangle on uniform
    noise in [noise[0], noise[1])), written as JPEGs with cv2, so a device
    letterbox really resizes. Category ids are 1-3; every entry carries its
    height and width. Returns (images_dir, annotations.json path).

    Train-step parity against JAX wants full-range noise, (0, 256): on the
    default low-contrast background the deepest batch-stat BNs of a random
    yolov10n at 96 px see near-zero variances, and the two packages' fp32
    train-mode head maps differ by about 1% of scale from identical float
    input (fp32 summation order through the one-pass variance), though the
    losses on identical maps agree to 1e-6."""
    import json
    import os

    import cv2

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i in range(n_images):
        h, w = sizes[i % len(sizes)]
        img = rng.randint(noise[0], noise[1], (h, w, 3)).astype(np.uint8)
        for _ in range(int(rng.randint(1, 4))):
            cls = int(rng.randint(0, 3))
            s = int(rng.uniform(0.2, 0.45) * min(h, w))
            x, y = int(rng.uniform(0, w - s - 1)), int(rng.uniform(0, h - s - 1))
            color = tuple(int(c) for c in np.clip(np.asarray([(40, 40, 200), (40, 200, 40), (200, 40, 40)][cls])
                                                   + rng.randint(-25, 26, 3), 0, 255))
            if cls == 0:
                cv2.rectangle(img, (x, y), (x + s, y + s), color, -1)
            elif cls == 1:
                cv2.circle(img, (x + s // 2, y + s // 2), s // 2, color, -1)
            else:
                cv2.fillPoly(img, [np.asarray([[x + s // 2, y], [x, y + s], [x + s, y + s]], np.int32)], color)
            anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": cls + 1,
                         "bbox": [float(x), float(y), float(s + 1), float(s + 1)], "area": float((s + 1) ** 2),
                         "iscrowd": 0})
        name = f"img_{i:04d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), img)
        images.append({"id": i + 1, "file_name": name, "width": w, "height": h})
    ann_path = os.path.join(root, "annotations.json")
    with open(ann_path, "w", encoding="utf-8") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": k + 1, "name": n} for k, n in enumerate(("rect", "circle", "triangle"))]},
                  f)
    return img_dir, ann_path


def jax_and_port_models(name: str, nc: int, seed: int):
    """(JAX YOLOv10, port YOLOv10) with the same seeded parameters and
    randomized BN statistics (`randomize_bn`), the port's on the CPU."""
    from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.models.yolov10.convert import load_jax_params

    jm = JYOLOv10.create(name, class_names=[f"c{i}" for i in range(nc)], seed=seed)
    jm = JYOLOv10(cfg=jm.cfg, class_names=jm.class_names, params=randomize_bn(jm.params, np.random.RandomState(seed)))
    return jm, load_jax_params(YOLOv10.create(name, class_names=jm.class_names), jm.params)


def calibrated_model(seed: int, images: np.ndarray, nc: int = 3):
    """yolov10n with BN statistics set from what each BN sees on `images`
    (uint8 [B, S, S, 3]), and each final class conv rescaled so that its
    logits there have mean -4 and std 1 per class."""
    from leanyolo_tpu_torch import YOLOv10
    from leanyolo_tpu_torch.models.yolov10.layers import BatchNorm

    model = YOLOv10.create("yolov10n", class_names=[f"class{c}" for c in range(nc)], seed=seed).eval()
    cls_convs = [seq[-1] for seq in (*model.head.cv3, *model.head.one2one_cv3)]

    def set_stats(bn, args):
        y = args[0].float()
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(y.var(dim=(0, 2, 3)))

    def spread(conv, args, out):
        mean, std = out.mean(dim=(0, 2, 3)), out.std(dim=(0, 2, 3))
        conv.weight.mul_((1.0 / std).view(-1, 1, 1, 1))
        conv.bias.copy_((conv.bias - mean) / std - 4.0)

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules() if isinstance(m, BatchNorm)]
    hooks += [c.register_forward_hook(spread) for c in cls_convs]
    with torch.no_grad():
        model(torch.from_numpy(images))
    for h in hooks:
        h.remove()
    return model


def self_labels(results: list, image_ids: list) -> list:
    """COCO annotations from detections at least 2 px wide and high: those
    scoring at or above one threshold, the lowest third-highest score of an
    image (so every image gets at least 3)."""
    big = [r for r in results if r["bbox"][2] >= 2 and r["bbox"][3] >= 2]
    thr = min(sorted((r["score"] for r in big if r["image_id"] == i), reverse=True)[2] for i in image_ids)
    anns = [{"id": k + 1, "image_id": r["image_id"], "category_id": r["category_id"], "bbox": r["bbox"],
             "area": r["bbox"][2] * r["bbox"][3], "iscrowd": 0}
            for k, r in enumerate(r for r in big if r["score"] >= thr)]
    assert min(sum(a["image_id"] == i for a in anns) for i in image_ids) >= 3
    return anns
