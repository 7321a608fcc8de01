"""Batched inference: uint8 NHWC images -> fixed-shape detections.

Counterpart of the JAX package's `Predictor` (`leanyolo_tpu/engine/predictor.py:43-104`,
`run_batch` at `:224-227`) on its serving path: the NMS-free top-k decode
over the one2one branch. The NMS decode and the host letterbox
(`predict_images`) belong to later slices.

It runs on the card unless the caller names another device; with no card
and no device named, it raises rather than run on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..models.yolov10.decode import decode_topk
from ..models.yolov10.fold import fold_model
from ..models.yolov10.model import YOLOv10

_DTYPES = {"float32": torch.float32, "fp32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


class Predictor:
    """Detector over [B, imgsz, imgsz, 3] batches.

    Args:
        model: a YOLOv10 module (unfolded; fuse=True folds a copy).
        imgsz: square input size, a multiple of 32.
        decode: 'topk' (the only decode of this slice).
        dtype: compute dtype, 'float32' or 'bfloat16'. With fuse=True and
            bfloat16 the folded weights are cast once.
        fuse: fold BN, RepVGGDW and the input normalization into the convs;
            the folded model runs the fused-stem and dw7x7 kernels.
        device: where to run; None means the card ('cuda'), and raises when
            there is none.
    """

    def __init__(self, model: YOLOv10, *, imgsz: int = 640, decode: str = "topk", conf_thresh: float = 0.25,
                 max_det: int = 300, dtype: str = "float32", fuse: bool = False,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if imgsz % 32:
            raise ValueError("imgsz must be divisible by 32")
        if decode != "topk":
            raise NotImplementedError(f"decode={decode!r}: only 'topk' is ported so far")
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Predictor: no CUDA device; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.dtype = _DTYPES[dtype]
        if fuse:
            model = fold_model(model, dtype=self.dtype if self.dtype == torch.bfloat16 else None)
        self.model = model.to(self.device).eval()
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.imgsz = int(imgsz)
        self.conf_thresh = float(conf_thresh)
        self.max_det = int(max_det)
        # Folded, the normalization lives in conv0 and the stem reads raw pixels.
        self._normalize = not fuse

    @torch.inference_mode()
    def raw(self, images) -> list:
        """Head maps of the one2one branch: per level (reg, cls) NHWC tuples."""
        x = (images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))).to(self.device)
        out = self.model(x, dtype=self.dtype, branches=("one2one",), normalize=self._normalize, concat_head=False)
        return out["one2one"]

    @torch.inference_mode()
    def run_batch(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: [B, S, S, 3] raw pixels (uint8 preferred; float accepted),
        a tensor or an array -> (dets [B, k, 6] fp32, num [B] int32), on the
        predictor's device."""
        cfg = self.model.cfg
        dets = decode_topk(self.raw(images), num_classes=self.model.nc, strides=cfg.strides, max_det=self.max_det)
        num = (dets[..., 4] > self.conf_thresh).sum(dim=-1).to(torch.int32)
        return dets.float(), num
