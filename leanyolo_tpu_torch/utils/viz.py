"""Detection drawing on the host, with numpy and PIL (no cv2).

Counterpart of the JAX package's `leanyolo_tpu/utils/viz.py:13-37`
(`draw_detections`): each box outlined in green, and above it a filled
green label background holding "name (cls) pct%" in black. The port's
images are RGB; JAX draws on BGR images, and its green (0, 255, 0) is green
in both orders.

The outline and the label background are cv2's pixels: `cv2.rectangle` at
thickness 2 draws a 3-pixel band centred on each edge, without the band's
four outer corner pixels, and filled it covers the closed rectangle. The
label background's size is `cv2.getTextSize(label, FONT_HERSHEY_SIMPLEX,
0.5, 1)`, from this module's table of that font's metrics at that scale
(`_ADVANCE`, `_DESCENT`, tabulated from OpenCV 5.0's `getTextSize`: the
width is the sum of the characters' advances plus 1, the height 14, the
baseline the largest descent). Characters outside printable ASCII take
'?''s metrics. The text itself is drawn with PIL's default font, the one
place where the pixels differ from cv2's `putText`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

GREEN = (0, 255, 0)
BLACK = (0, 0, 0)
TEXT_HEIGHT = 14  # getTextSize's height at scale 0.5, thickness 1

_PRINTABLE = "".join(chr(c) for c in range(32, 127))
# Per printable ASCII character (space .. '~'): the advance in pixels and
# the descent below the baseline at FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1.
_ADVANCE = dict(zip(_PRINTABLE, (
    3, 3, 5, 10, 9, 11, 10, 3, 9, 9, 6, 9, 3, 7, 3, 7, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 3, 4, 7, 8, 7, 7,
    12, 10, 10, 9, 10, 9, 8, 10, 10, 4, 9, 9, 8, 11, 10, 10, 9, 10, 9, 9, 8, 10, 9, 11, 9, 9, 8, 4, 7, 4, 6, 11,
    5, 8, 8, 8, 8, 8, 5, 8, 9, 3, 3, 7, 3, 13, 9, 8, 8, 8, 5, 7, 5, 9, 8, 12, 8, 8, 7, 5, 3, 5, 8)))
_DESCENT = dict(zip(_PRINTABLE, (
    0, 0, 0, 0, 2, 1, 1, 0, 2, 2, 0, 0, 2, 0, 0, 2, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 2, 0, 0, 0, 0,
    2, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 3, 2, 3, 0, 1,
    0, 1, 1, 1, 1, 1, 0, 4, 0, 0, 3, 0, 0, 0, 0, 1, 3, 3, 0, 1, 0, 1, 0, 0, 0, 3, 0, 3, 4, 3, 0)))


def text_size(label: str) -> Tuple[Tuple[int, int], int]:
    """((width, height), baseline) of `label` as cv2.getTextSize(label,
    FONT_HERSHEY_SIMPLEX, 0.5, 1) gives them."""
    if not label:
        return (0, 0), 0
    chars = [c if c in _ADVANCE else "?" for c in label]
    return (sum(_ADVANCE[c] for c in chars) + 1, TEXT_HEIGHT), max(_DESCENT[c] for c in chars)


def fill_rect(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """cv2.rectangle(img, p1, p2, color, -1): the closed rectangle, clipped."""
    (xa, xb), (ya, yb) = sorted((p1[0], p2[0])), sorted((p1[1], p2[1]))
    img[max(ya, 0):max(yb + 1, 0), max(xa, 0):max(xb + 1, 0)] = color


def outline_rect(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], color) -> None:
    """cv2.rectangle(img, p1, p2, color, 2): a 3-pixel band centred on each
    edge, less the band's four outer corner pixels, clipped."""
    h, w = img.shape[:2]
    (xa, xb), (ya, yb) = sorted((p1[0], p2[0])), sorted((p1[1], p2[1]))
    corners = [(y, x) for y in (ya - 1, yb + 1) for x in (xa - 1, xb + 1) if 0 <= y < h and 0 <= x < w]
    kept = [img[y, x].copy() for y, x in corners]
    for y0, y1, x0, x1 in ((ya - 1, ya + 1, xa - 1, xb + 1), (yb - 1, yb + 1, xa - 1, xb + 1),
                           (ya - 1, yb + 1, xa - 1, xa + 1), (ya - 1, yb + 1, xb - 1, xb + 1)):
        img[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = color
    for (y, x), v in zip(corners, kept):
        img[y, x] = v


def label_text(cls: int, score: float, class_names: Optional[Sequence[str]]) -> str:
    """"name (cls) pct%", the class index where no name is known."""
    name = class_names[cls] if class_names and 0 <= cls < len(class_names) else str(cls)
    return f"{name} ({cls}) {score * 100:.0f}%"


def put_text(img: np.ndarray, label: str, org: Tuple[int, int], font) -> None:
    """Black antialiased `label` with its baseline's left end at `org` in a
    PIL font, blended into img (clipped)."""
    from PIL import Image, ImageDraw

    left, top, right, bottom = font.getbbox(label, anchor="ls")
    if right <= left or bottom <= top:
        return
    mask = Image.new("L", (right - left, bottom - top))
    ImageDraw.Draw(mask).text((-left, -top), label, fill=255, font=font, anchor="ls")
    alpha = np.asarray(mask, dtype=np.float32) / 255.0
    x0, y0 = org[0] + left, org[1] + top
    h, w = img.shape[:2]
    ya, yb, xa, xb = max(y0, 0), min(y0 + alpha.shape[0], h), max(x0, 0), min(x0 + alpha.shape[1], w)
    if ya >= yb or xa >= xb:
        return
    a = alpha[ya - y0:yb - y0, xa - x0:xb - x0, None]
    img[ya:yb, xa:xb] = np.rint(img[ya:yb, xa:xb] * (1.0 - a)).astype(np.uint8)


def draw_detections(img_rgb: np.ndarray, dets: np.ndarray,
                    class_names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Draw [N, 6] detections ([x1, y1, x2, y2, score, cls]) on a copy of an
    RGB uint8 image, in order: each box's outline, label background and text."""
    from PIL import ImageFont

    out = np.array(img_rgb, dtype=np.uint8, copy=True)
    font = ImageFont.load_default()
    for det in np.asarray(dets):
        x1, y1, x2, y2, score, cls = det[:6]
        cls = int(cls)
        p1 = (int(round(x1)), int(round(y1)))
        p2 = (int(round(x2)), int(round(y2)))
        outline_rect(out, p1, p2, GREEN)
        label = label_text(cls, score, class_names)
        (tw, th), baseline = text_size(label)
        ty = max(p1[1] - 4, th + 2)
        fill_rect(out, (p1[0], ty - th - 2), (p1[0] + tw + 2, ty + baseline - 2), GREEN)
        put_text(out, label, (p1[0] + 1, ty - 2), font)
    return out


def save_image(path: str, img_rgb: np.ndarray) -> None:
    """Write an RGB uint8 image, its format by the file's extension; JPEG at
    quality 95, cv2.imwrite's default."""
    from PIL import Image

    ext = path.rsplit(".", 1)[-1].lower()
    Image.fromarray(np.ascontiguousarray(img_rgb, dtype=np.uint8)).save(
        path, **({"quality": 95} if ext in ("jpg", "jpeg") else {}))
