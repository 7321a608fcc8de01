"""Batched inference: images -> fixed-shape detections, and the host
pipeline from images of any size to boxes in their own coordinates.

Counterpart of the JAX package's `Predictor`
(`leanyolo_tpu/engine/predictor.py`) without its buffer donation and its
`space` and `model` mesh axes (ROADMAP.md Queue 1 item 7):

- decode 'topk': the NMS-free two-stage top-k over the one2one branch;
- decode 'nms': confidence threshold + greedy (optionally class-wise) NMS
  over the one2many branch, fixed-shape with a count. JAX upcasts the head
  maps to fp32 first; the port ranks the bf16 maps as fp32 instead
  (`decode_nms(rank_dtype=torch.float32)`), which gives the same result,
  since the upcast is exact.

`predict_images` letterboxes on the host (numpy, cv2's fixed point) or on
the device (`run_canvas`: a canvas warped by torch ops) and maps the boxes
back to each original image.

With a mesh (data parallel, one process a card) `run_batch` and `run_canvas`
take the global batch on every process: each process runs its rows through
the serving path on its own device, and an all-gather returns the global
detections to every process, as JAX's batch-sharded outputs are.

It runs on the card unless the caller names another device; with no card
and no device named, it raises rather than run on the CPU.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.yolov10.decode import decode_nms, decode_topk, postprocess_to_original
from ..models.yolov10.fold import fold_model
from ..models.yolov10.model import YOLOv10
from ..ops.letterbox import canvas_batch, letterbox, letterbox_batch

_DTYPES = {"float32": torch.float32, "fp32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
_BRANCH = {"topk": "one2one", "nms": "one2many"}


class Predictor:
    """Detector over [B, imgsz, imgsz, 3] batches.

    Args:
        model: a YOLOv10 module (unfolded; fuse=True folds a copy).
        imgsz: square input size, a multiple of 32.
        decode: 'topk' or 'nms'.
        conf_thresh, iou_thresh, max_det, class_wise_nms: the decode's.
        dtype: compute dtype, 'float32' or 'bfloat16'. With fuse=True and
            bfloat16 the folded weights are cast once.
        fuse: fold BN, RepVGGDW and the input normalization into the convs;
            the folded model runs the port's conv kernels.
        device: where to run; None means the card ('cuda', this process's
            card), and raises when there is none.
        mesh: a DeviceMesh over the job's processes (parallel/mesh.py): the
            weights are broadcast from its first process and batches split
            over it (`update_params` loads on each process what it is
            given). None, or a mesh of one process: this process alone.
    """

    def __init__(self, model: YOLOv10, *, imgsz: int = 640, decode: str = "topk", conf_thresh: float = 0.25,
                 iou_thresh: float = 0.45, max_det: int = 300, class_wise_nms: bool = False,
                 dtype: str = "float32", fuse: bool = False,
                 device: Optional[Union[str, torch.device]] = None, mesh=None) -> None:
        if imgsz % 32:
            raise ValueError("imgsz must be divisible by 32")
        if decode not in _BRANCH:
            raise ValueError(f"unknown decode {decode!r}: 'topk' or 'nms'")
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Predictor: no CUDA device; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.dtype = _DTYPES[dtype]
        self._fuse = fuse
        self.mesh, self._group = mesh, None
        if mesh is not None and mesh.size() > 1:
            from ..parallel.mesh import mesh_group, shard_params

            # Every process serves the first process's weights (broadcast in fp32, before folding).
            self._group = mesh_group(mesh)
            model = shard_params(mesh, copy.deepcopy(model).to(self.device))
        # The predictor's own copy (folding makes one): moving it to the device
        # and update_params leave the caller's module as it was.
        if fuse:
            model = fold_model(model, dtype=self.dtype if self.dtype == torch.bfloat16 else None)
        else:
            model = copy.deepcopy(model)
        self.model = model.to(self.device).eval()
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.imgsz = int(imgsz)
        self.decode = decode
        self.conf_thresh = float(conf_thresh)
        self.iou_thresh = float(iou_thresh)
        self.max_det = int(max_det)
        self.class_wise_nms = bool(class_wise_nms)
        # Folded, the normalization lives in conv0 and the stem reads raw pixels.
        self._normalize = not fuse

    @torch.no_grad()
    def update_params(self, state) -> None:
        """Load new weights into this predictor: `state` is a YOLOv10 module
        or its state dict, unfolded (folded here first when fuse=True) or
        already folded. The packed kernel weights are packed again by the
        modules' load hooks."""
        if isinstance(state, torch.nn.Module):
            state = state.state_dict()
        if self._fuse and any(k.endswith("running_var") for k in state):
            m = self.model
            src = YOLOv10(m.cfg, m.class_names, in_channels=m.input_subtract.numel())
            src.load_state_dict(state)
            state = fold_model(src, dtype=self.dtype if self.dtype == torch.bfloat16 else None).state_dict()
        self.model.load_state_dict(state)

    @torch.inference_mode()
    def raw(self, images) -> list:
        """Head maps of the decode's branch: per level (reg, cls) NHWC tuples."""
        x = (images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))).to(self.device)
        if x.is_floating_point():
            x = x.to(self.dtype)
        branch = _BRANCH[self.decode]
        out = self.model(x, dtype=self.dtype, branches=(branch,), normalize=self._normalize, concat_head=False)
        return out[branch]

    def _rows(self, a):
        """This process's rows of a global-batch array (all of it off a mesh)."""
        if self._group is None:
            return a
        from ..parallel.mesh import batch_sharded

        return a[batch_sharded(self.mesh, a.shape[0])]

    def _gathered(self, dets: torch.Tensor, num: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every process's rows, in mesh order, on every process."""
        if self._group is None:
            return dets, num
        out = []
        for t in (dets, num):
            parts = [torch.empty_like(t) for _ in range(self.mesh.size())]
            dist.all_gather(parts, t.contiguous(), group=self._group)
            out.append(torch.cat(parts))
        return out[0], out[1]

    @torch.inference_mode()
    def run_batch(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """images: [B, S, S, 3] raw pixels (uint8 preferred; float accepted),
        a tensor or an array -> (dets [B, max_det, 6] fp32, num [B] int32),
        on the predictor's device. On a mesh, B (the global batch) must
        divide by its processes."""
        return self._gathered(*self._run(self._rows(images)))

    def _run(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, nc = self.model.cfg, self.model.nc
        raw = self.raw(images)
        if self.decode == "topk":
            dets = decode_topk(raw, num_classes=nc, strides=cfg.strides, max_det=self.max_det)
            num = (dets[..., 4] > self.conf_thresh).sum(dim=-1).to(torch.int32)
            return dets.float(), num
        return decode_nms(raw, num_classes=nc, strides=cfg.strides, conf_thresh=self.conf_thresh,
                          iou_thresh=self.iou_thresh, max_det=self.max_det, class_wise=self.class_wise_nms,
                          rank_dtype=torch.float32)

    @torch.inference_mode()
    def run_canvas(self, canvas, new_hw, pads, hw) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device-preprocess path: canvas [B, Hc, Wc, 3] with image i at
        its top-left, geometry as `canvas_batch` gives it; the letterbox warp
        runs on the predictor's device, then `run_batch`."""
        canvas, new_hw, pads, hw = (self._rows(a) for a in (canvas, new_hw, pads, hw))
        canvas = (canvas if torch.is_tensor(canvas) else torch.from_numpy(np.asarray(canvas))).to(self.device)
        return self._gathered(*self._run(letterbox_batch(canvas, new_hw, pads, hw, self.imgsz)))

    def predict_images(self, images_rgb: Sequence[np.ndarray], *, apply_conf_filter: bool = True,
                       preprocess: str = "host") -> List[np.ndarray]:
        """HWC RGB images of any size -> per image an array [N, 6] of
        [x1, y1, x2, y2, score, cls] in its own coordinates.

        preprocess='host': the numpy letterbox per image (cv2's pixels).
        'device': the images on one canvas, letterboxed on the device (a
        bilinear warp in fp32, not cv2's fixed point: equal up to the last
        bits of a pixel).
        """
        if preprocess == "device":
            canvas, new_hw, pads, hw, metas = canvas_batch(images_rgb, self.imgsz)
            dets, num = self.run_canvas(canvas, new_hw, pads, hw)
        elif preprocess == "host":
            lbs, metas = [], []
            for img in images_rgb:
                lb, gain, pad = letterbox(img, self.imgsz)
                lbs.append(np.ascontiguousarray(lb, dtype=np.uint8))
                metas.append((gain, pad, img.shape[:2]))
            dets, num = self.run_batch(np.stack(lbs))
        else:
            raise ValueError(f"unknown preprocess {preprocess!r}: 'host' or 'device'")
        return postprocess_to_original(dets, num, metas, decode=self.decode, conf_thresh=self.conf_thresh,
                                       apply_conf_filter=apply_conf_filter)
