"""Letterbox preprocessing: the host path in numpy and the device warp in torch.

Counterpart of the JAX package's `leanyolo_tpu/ops/letterbox.py`, without
cv2 (the port depends on torch and numpy only). The host `letterbox` reproduces
`cv2.resize(..., INTER_LINEAR)` on uint8 images in cv2's own fixed point:
each destination pixel's source position is (d + 0.5) * src/dst - 0.5 in
fp32, its two weights are rounded to 11-bit integers (2048 = 1.0), a
horizontal pass sums into ints, and the vertical pass rounds as cv2's
vectorised pass does, ((a >> 4) * b0 >> 16) + ((c >> 4) * b1 >> 16) + 2 >> 2.
Edge columns clamp with weight 2048 on the last pixel; edge rows clamp the
row index. Other dtypes take the same geometry in fp32 arithmetic.

The device path (`letterbox_batch`) is the JAX device warp as torch ops:
images of any size pasted top-left on a fixed canvas, resized and padded on
the device with per-image geometry given as tensors (gathers and blends).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
_ONE = 1 << _COEF_BITS


def _axis(dst: int, src: int):
    """Source index and fp32 fraction of each destination pixel (cv2's geometry)."""
    scale = 1.0 / (dst / src)  # cv2: scale_x = 1. / inv_scale_x, in double
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _weights(f: np.ndarray):
    w0 = np.rint((np.float32(1.0) - f).astype(np.float32) * np.float32(_ONE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_ONE)).astype(np.int64)
    return w0, w1


def resize_linear(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """cv2.resize(img, (new_w, new_h), interpolation=INTER_LINEAR) for an
    [H, W, C] image: bit-exact for uint8, cv2's geometry in fp32 otherwise."""
    h, w = img.shape[:2]
    sx, fx = _axis(new_w, w)
    fx = np.where(sx < 0, np.float32(0), fx)
    sx = np.maximum(sx, 0)
    last = sx >= w - 1
    fx = np.where(last, np.float32(0), fx)
    sx = np.where(last, w - 1, sx)
    sx1 = np.minimum(sx + 1, w - 1)
    sy, fy = _axis(new_h, h)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    src = img if img.ndim == 3 else img[..., None]
    if img.dtype != np.uint8:
        src = src.astype(np.float32)
        rows = src[:, sx] * (np.float32(1) - fx)[None, :, None] + src[:, sx1] * fx[None, :, None]
        out = rows[y0] * (np.float32(1) - fy)[:, None, None] + rows[y1] * fy[:, None, None]
        return out.astype(img.dtype).reshape((new_h, new_w) + img.shape[2:])
    a0, a1 = _weights(fx)
    b0, b1 = _weights(fy)
    src = src.astype(np.int64)
    rows = src[:, sx] * a0[None, :, None] + src[:, sx1] * a1[None, :, None]
    rows = np.where(last[None, :, None], src[:, sx] * _ONE, rows)
    r0, r1 = rows[y0], rows[y1]
    out = ((((r0 >> 4) * b0[:, None, None]) >> 16) + (((r1 >> 4) * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((new_h, new_w) + img.shape[2:])


def letterbox(img: np.ndarray, new_shape=640, color: Tuple[int, int, int] = (114, 114, 114), auto: bool = False,
              scale_fill: bool = False, scaleup: bool = True, stride: int = 32):
    """Aspect-preserving resize + centred constant pad (host).

    Returns (img_out, (gain_w, gain_h), (pad_left, pad_top)), with `auto`
    stride-multiple padding, `scale_fill` stretching and `scaleup=False`
    capping as the JAX `letterbox` (reference letterbox.py:41-91).
    """
    orig_h, orig_w = img.shape[:2]
    if isinstance(new_shape, int):
        tgt_h, tgt_w = new_shape, new_shape
    else:
        tgt_h, tgt_w = int(new_shape[0]), int(new_shape[1])

    if scale_fill:
        gain_w = tgt_w / max(orig_w, 1)
        gain_h = tgt_h / max(orig_h, 1)
        new_w, new_h = tgt_w, tgt_h
        pad_w = pad_h = 0.0
    else:
        r = min(tgt_w / max(orig_w, 1), tgt_h / max(orig_h, 1))
        if not scaleup:
            r = min(r, 1.0)
        new_w = int(round(orig_w * r))
        new_h = int(round(orig_h * r))
        gain_w = gain_h = r
        pad_w = float(tgt_w - new_w)
        pad_h = float(tgt_h - new_h)
        if auto and stride > 1:
            pad_w = pad_w % stride
            pad_h = pad_h % stride

    if (orig_w, orig_h) != (new_w, new_h):
        img = resize_linear(img, new_w, new_h)

    left = int(round(pad_w / 2.0))
    right = int(round(pad_w - left))
    top = int(round(pad_h / 2.0))
    bottom = int(round(pad_h - top))
    if any(v != 0 for v in (top, bottom, left, right)):
        out = np.empty((new_h + top + bottom, new_w + left + right) + img.shape[2:], img.dtype)
        out[...] = np.asarray(color, dtype=img.dtype)[: img.shape[2]] if img.ndim == 3 else color[0]
        out[top:top + new_h, left:left + new_w] = img
        img = out
    return img, (float(gain_w), float(gain_h)), (left, top)


DEFAULT_SIZE_BUCKETS = (320, 416, 512, 640, 768, 896, 1088, 1280)


def choose_bucket(orig_hw: Tuple[int, int], buckets=DEFAULT_SIZE_BUCKETS, max_size: int = 1280) -> int:
    """The smallest stride-32 bucket that fits the image's long side (larger
    images downscale into the largest bucket)."""
    long_side = max(orig_hw)
    for b in buckets:
        if long_side <= b:
            return b
    return min(max(buckets), max_size)


def letterbox_params(orig_hw: Tuple[int, int], target: int, scaleup: bool = True):
    """Letterbox geometry for a known original size: ((gain_w, gain_h),
    (left, top), (new_h, new_w)) (host math only)."""
    orig_h, orig_w = orig_hw
    r = min(target / max(orig_w, 1), target / max(orig_h, 1))
    if not scaleup:
        r = min(r, 1.0)
    new_w = int(round(orig_w * r))
    new_h = int(round(orig_h * r))
    pad_w = float(target - new_w)
    pad_h = float(target - new_h)
    left = int(round(pad_w / 2.0))
    top = int(round(pad_h / 2.0))
    return (r, r), (left, top), (new_h, new_w)


def _axis_coords(n_new: torch.Tensor, n_true: torch.Tensor, offset: torch.Tensor, target: int):
    """Per image [B] geometry -> (i0, i1, frac, valid), each [B, target]: the
    JAX warp's cv2-convention source coordinates, in fp32."""
    dst = torch.arange(target, device=n_new.device)[None, :] - offset[:, None]
    ratio = n_true.float() / n_new.float()
    src = (dst.float() + 0.5) * ratio[:, None] - 0.5
    src = torch.minimum(torch.clamp_min(src, 0.0), (n_true.float() - 1.0)[:, None])
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.minimum(i0 + 1, (n_true - 1)[:, None].to(torch.int64))
    frac = src - i0.float()
    valid = (dst >= 0) & (dst < n_new[:, None])
    return i0, i1, frac, valid


def letterbox_batch(canvas: torch.Tensor, new_hw: torch.Tensor, pads: torch.Tensor, hw: torch.Tensor, target: int,
                    *, pad_value: float = 114.0) -> torch.Tensor:
    """Batched device letterbox (JAX `letterbox_batch_jax`): canvas [B, Hc,
    Wc, 3] (uint8 or float, image i at [:h_i, :w_i]); new_hw, pads (left,
    top) and hw [B, 2] int -> [B, target, target, 3] float32, a separable
    bilinear warp with cv2's half-pixel centres, pad_value outside."""
    dev = canvas.device
    new_hw, pads, hw = (torch.as_tensor(t, device=dev) for t in (new_hw, pads, hw))
    img = canvas.float()
    b = img.shape[0]
    y0, y1, fy, vy = _axis_coords(new_hw[:, 0], hw[:, 0], pads[:, 1], target)
    x0, x1, fx, vx = _axis_coords(new_hw[:, 1], hw[:, 1], pads[:, 0], target)
    bi = torch.arange(b, device=dev)[:, None]
    rows = img[bi, y0] * (1.0 - fy)[..., None, None] + img[bi, y1] * fy[..., None, None]  # [B, T, Wc, 3]
    out = rows[bi, :, x0].transpose(1, 2) * (1.0 - fx)[:, None, :, None] \
        + rows[bi, :, x1].transpose(1, 2) * fx[:, None, :, None]
    inside = (vy[:, :, None] & vx[:, None, :])[..., None]
    return torch.where(inside, out, torch.full_like(out, pad_value))


def canvas_batch(images, target: int, *, canvas_size: Optional[int] = None, scaleup: bool = True):
    """Host prep for `letterbox_batch`: paste images top-left onto a fixed
    canvas (a copy per image, no resize). Returns (canvas [B, C, C, 3]
    uint8, or float32 where an image is not uint8; new_hw, pads, hw [B, 2]
    int32; metas [(gain, pad, (h, w))] as the host letterbox gives them)."""
    if canvas_size is None:
        longest = max(max(int(im.shape[0]), int(im.shape[1])) for im in images)
        # The canvas fits the raw image (the warp downscales to `target`);
        # sizes past the buckets round up to a coarse 256 step.
        canvas_size = max(target, choose_bucket((longest, longest)), (longest + 255) // 256 * 256)
    b = len(images)
    cdt = np.uint8 if all(np.asarray(im).dtype == np.uint8 for im in images) else np.float32
    canvas = np.zeros((b, canvas_size, canvas_size, 3), cdt)
    new_hw = np.zeros((b, 2), np.int32)
    pads = np.zeros((b, 2), np.int32)
    hw = np.zeros((b, 2), np.int32)
    metas = []
    for i, img in enumerate(images):
        h, w = int(img.shape[0]), int(img.shape[1])
        if h > canvas_size or w > canvas_size:
            raise ValueError(f"image {h}x{w} exceeds canvas {canvas_size}")
        (gw, gh), (left, top), (nh, nw) = letterbox_params((h, w), target, scaleup)
        canvas[i, :h, :w] = img[..., :3]
        new_hw[i] = (nh, nw)
        pads[i] = (left, top)
        hw[i] = (h, w)
        metas.append(((gw, gh), (left, top), (h, w)))
    return canvas, new_hw, pads, hw, metas


def dataset_canvas_size(images_meta, target: int) -> int:
    """Canvas size for a whole COCO dataset from its annotation sizes (one
    canvas, one shape for the epoch); raises where an entry lacks them."""
    missing = [im for im in images_meta if not (im.get("height") and im.get("width"))]
    if missing:
        raise ValueError(
            f"device preprocessing sizes the canvas from the annotations, but "
            f"{len(missing)} image entries lack height/width (first: "
            f"{missing[0].get('file_name', missing[0].get('id'))}); use "
            f"preprocess='host' or fix the annotation json"
        )
    longest = 1
    for im in images_meta:
        longest = max(longest, int(im["height"]), int(im["width"]))
    return max(target, choose_bucket((longest, longest)), (longest + 255) // 256 * 256)


def letterbox_image(img, target: int, *, pad_value: float = 114.0, scaleup: bool = True, device=None):
    """Device letterbox of one image (JAX `letterbox_jax`): [H, W, 3] ->
    ([target, target, 3] float32, (gain_w, gain_h), (pad_left, pad_top)),
    a linear resize (antialiased when it shrinks, as `jax.image.resize`)
    then a constant pad."""
    x = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img) else img, device=device).float()
    h, w = int(x.shape[0]), int(x.shape[1])
    (gw, gh), (left, top), (new_h, new_w) = letterbox_params((h, w), target, scaleup)
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(new_h, new_w), mode="bilinear", align_corners=False,
                      antialias=True)[0].permute(1, 2, 0)
    out = torch.full((target, target, x.shape[2]), pad_value, dtype=torch.float32, device=x.device)
    out[top:top + new_h, left:left + new_w] = y
    return out, (gw, gh), (left, top)
