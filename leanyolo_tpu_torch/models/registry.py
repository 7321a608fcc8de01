"""Model registry and public API: get_model / list_models / get_model_weights.

Counterpart of the JAX package's `leanyolo_tpu/models/registry.py`:

- name -> builder over the six YOLOv10 variants;
- `weights=None` -> random init from `seed` (the port's own generator: not
  JAX's random numbers);
- `weights=<path>` -> strict load, no remapping (native `.npz` checkpoints
  or lean torch-layout `.pt` files);
- `weights='PRETRAINED_COCO'` -> resolve through the per-variant URL and
  SHA-256 table (`LEANYOLO_WEIGHTS_DIR`, then the cache, then a download),
  remap the official checkpoint, warn with coverage statistics, and on
  failure warn and keep the random init.

The model is built on the CPU; loading is host work. `Predictor` and
`Trainer` move it to the card.

Native `.npz` checkpoints hold what the JAX package's `save_checkpoint`
writes: torch-style keys, conv kernels HWIO, the input norms as `[C]`, and a
JSON metadata record. So either package reads the other's files.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Iterable, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..utils.weights import WeightsEntry
from .yolov10.config import VARIANTS
from .yolov10.convert import module_leaves, path_to_torch_key
from .yolov10.model import YOLOv10
from .yolov10.remap import convert_leaf, torch_sd_to_state


class _YOLOv10Weights:
    """Official THU-MIG YOLOv10 release weights (v1.1), per variant."""

    _SHA = {
        "yolov10n": "61b91ffc99b284792dca49bf40216945833cc2a515e1a742954e6e9327cfc19e",
        "yolov10s": "96af3fc7c7169abcc4867f3e3088b761bb33cf801283c2ec05f9703d63a0ba77",
        "yolov10m": "ff2c559f11d13701abc4e0345f82851d146ecfe7035efaafcc08475cfd8b5f2d",
        "yolov10b": "3846434cbf0016b663a1ccd6d843c48468f6852f4feeddcb9f67f9182168c142",
        "yolov10l": "83769ec3cbc61f18113f612f8bdcf922396628d620682bb72966e9b148004b8b",
        "yolov10x": "6e6eae65e6c268c49a25849922e0c75a5c707d626d67170d16a97813b0f8eb79",
    }

    MODEL_TO_WEIGHTS: Dict[str, Dict[str, WeightsEntry]] = {
        name: {
            "PRETRAINED_COCO": WeightsEntry(
                name=f"{name}.PRETRAINED_COCO",
                url=f"https://github.com/THU-MIG/yolov10/releases/download/v1.1/{name}.pt",
                filename=f"{name}.pt",
                sha256=sha,
                metadata={"task": "detection", "dataset": "coco", "source": "THU-MIG/yolov10@v1.1"},
            )
        }
        for name, sha in _SHA.items()
    }

    def list(self, model_name: str) -> Iterable[str]:
        return self.MODEL_TO_WEIGHTS.get(model_name, {}).keys()

    def get(self, model_name: str, key: str) -> WeightsEntry:
        mapping = self.MODEL_TO_WEIGHTS.get(model_name)
        if not mapping or key not in mapping:
            raise KeyError(f"No weights '{key}' for model '{model_name}'.")
        return mapping[key]


def list_models() -> Iterable[str]:
    return tuple(VARIANTS.keys())


def get_model_weights(name: str) -> Type[_YOLOv10Weights]:
    if name not in VARIANTS:
        raise ValueError(f"Unknown model '{name}'. Available: {list_models()}")
    return _YOLOv10Weights


def _to3(x: Sequence[float]) -> Sequence[float]:
    if len(x) == 1:
        return [float(x[0])] * 3
    if len(x) != 3:
        raise ValueError("subtract_mean/divide must have length 1 or 3")
    return [float(v) for v in x]


def get_model(
    name: str,
    *,
    weights: Optional[str],
    class_names: Sequence[str],
    input_norm_subtract: Optional[Sequence[float]] = None,
    input_norm_divide: Optional[Sequence[float]] = None,
    seed: int = 0,
) -> YOLOv10:
    """Build a YOLOv10 variant on the CPU and optionally load weights.

    Inputs are NHWC RGB; normalization `(x - subtract) / divide` happens
    inside the model. Defaults (subtract 0, divide 255) expect raw [0, 255]
    pixels.
    """
    if name not in VARIANTS:
        raise ValueError(f"Unknown model '{name}'. Available: {list_models()}")
    sub3 = _to3(input_norm_subtract if input_norm_subtract is not None else (0.0, 0.0, 0.0))
    div3 = _to3(input_norm_divide if input_norm_divide is not None else (255.0, 255.0, 255.0))

    model = YOLOv10.create(name, class_names=class_names, input_norm_subtract=sub3, input_norm_divide=div3, seed=seed)

    if weights is None:
        return model
    if isinstance(weights, str) and os.path.isfile(weights):
        try:
            load_checkpoint_into(model, weights)
            return model
        except Exception as e:  # any reader or shape failure becomes one clear error
            raise ValueError(
                f"Failed to load local weights '{weights}': {e}. "
                "Provide a checkpoint compatible with this library version."
            ) from e
    if weights != "PRETRAINED_COCO":
        raise ValueError("weights must be a filename, 'PRETRAINED_COCO', or None")
    try:
        _load_official_pretrained_into_model(name, model)
    except Exception as e:  # the documented fallback: warn and keep the random init
        warnings.warn(
            f"Could not load weights '{weights}' for '{name}': {e}. "
            "Proceeding with randomly initialized weights.",
            RuntimeWarning,
        )
    return model


def _load_official_pretrained_into_model(model_name: str, model: YOLOv10) -> None:
    entry = _YOLOv10Weights().get(model_name, "PRETRAINED_COCO")
    src_sd = entry.get_state_dict()
    state, stats = torch_sd_to_state(src_sd, model, official=True)
    dst_total = len(state)
    loaded = dst_total - len(stats["missing"])
    warnings.warn(
        f"Weights loaded: {len(stats['matched'])}/{stats['src_total']} tensors from file "
        f"({100.0 * len(stats['matched']) / max(stats['src_total'], 1):.1f}%), "
        f"filled model: {loaded}/{dst_total} leaves ({100.0 * loaded / dst_total:.1f}%).",
        RuntimeWarning,
    )
    if stats["missing"]:
        warnings.warn(f"Missing leaves when loading weights: {sorted(stats['missing'])[:10]}...", RuntimeWarning)
    if stats["unused_src"]:
        warnings.warn(f"Unexpected keys when loading weights: {sorted(stats['unused_src'])[:10]}...", RuntimeWarning)
    model.load_state_dict(state)


# ---------------------------------------------------------------------------
# Native checkpoint save/load (.npz with JSON metadata)
# ---------------------------------------------------------------------------

CKPT_META_KEY = "__leanyolo_tpu_meta__"


def _to_file_layout(path: Tuple, t: torch.Tensor) -> np.ndarray:
    """A module tensor as the JAX leaf a `.npz` holds: fp32, conv kernels HWIO."""
    a = t.detach().float().cpu().numpy()
    return a.transpose(2, 3, 1, 0) if path[-1] == "w" and a.ndim == 4 else a


def _file_shape(path: Tuple, t: torch.Tensor) -> Tuple[int, ...]:
    s = tuple(t.shape)
    return (s[2], s[3], s[1], s[0]) if path[-1] == "w" and len(s) == 4 else s


def _from_file_layout(path: Tuple, a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t.permute(3, 2, 0, 1).contiguous() if path[-1] == "w" and t.ndim == 4 else t


def save_checkpoint(model: YOLOv10, path: str, *, extra_meta: Optional[dict] = None) -> None:
    """Save the model's state and metadata as a `.npz`, in the JAX package's
    format: torch-style keys, in the JAX tree's order; metadata keys
    leanyolo_version, model_name, class_names, input_norm_subtract and
    input_norm_divide (plus `extra_meta`)."""
    from ..version import __version__

    flat = {path_to_torch_key(p): _to_file_layout(p, t) for p, t in module_leaves(model)}
    meta = {
        "leanyolo_version": __version__,
        "model_name": model.cfg.name,
        "class_names": model.class_names,
        "input_norm_subtract": model.input_subtract.detach().float().cpu().tolist(),
        "input_norm_divide": model.input_divide.detach().float().cpu().tolist(),
    }
    if extra_meta:
        meta.update(extra_meta)
    flat[CKPT_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def load_checkpoint_meta(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        if CKPT_META_KEY not in z:
            return {}
        return json.loads(bytes(z[CKPT_META_KEY]).decode())


def _read_flat(path: str) -> Tuple[Dict, bool]:
    """(flat state dict, is_torch_file): a `.pt`/`.pth` through the safe
    reader (OIHW), else a `.npz` (JAX layout)."""
    if path.endswith(".pt") or path.endswith(".pth"):
        from ..utils.torch_reader import load_torch_checkpoint

        sd = load_torch_checkpoint(path)
        sd.pop("head.dfl.bins", None)  # derived buffer, not a parameter
        return sd, True
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files if k != CKPT_META_KEY}, False


def load_checkpoint_into(model: YOLOv10, path: str) -> None:
    """Strict local checkpoint load: keys and shapes must match exactly.

    Accepts native `.npz` checkpoints or torch `.pt` files whose state dict
    uses this library's lean key layout: no remapping, a clear error on any
    mismatch, and the model is left as it was when the load fails.
    """
    sd, is_torch = _read_flat(path)
    if is_torch:
        state, _ = torch_sd_to_state(sd, model, official=False, strict=True)
        model.load_state_dict(state)
        return
    leaves = {path_to_torch_key(p): (p, t) for p, t in module_leaves(model)}
    missing = sorted(set(leaves) - set(sd))
    unexpected = sorted(set(sd) - set(leaves))
    if missing or unexpected:
        raise ValueError(f"state mismatch: missing={missing[:5]} unexpected={unexpected[:5]}")
    state = {}
    for key, (p, t) in leaves.items():
        want = _file_shape(p, t)
        if tuple(sd[key].shape) != want:
            raise ValueError(f"shape mismatch for '{key}': {sd[key].shape} vs {want}")
        state[key] = _from_file_layout(p, sd[key])
    model.load_state_dict(state)


def load_checkpoint_transfer(model: YOLOv10, path: str) -> dict:
    """Lenient local load for transfer learning: fill every leaf whose key
    and shape match, keep the fresh init for the rest, return coverage
    statistics (the JAX function's).

    This is how 80-class COCO weights go into a model with another class
    count: the class-dependent head leaves are skipped with a warning.
    A `.pt` leaf is taken as a strict load takes it (the input norms flat),
    a `.npz` leaf is compared in the file's HWIO layout.
    """
    sd, is_torch = _read_flat(path)
    state = {}
    loaded, skipped, missing = [], [], []
    for p, t in module_leaves(model):
        key = path_to_torch_key(p)
        if key not in sd:
            missing.append(key)
            continue
        if is_torch:
            leaf = convert_leaf(sd[key], t.shape, p)
        else:
            leaf = _from_file_layout(p, sd[key]) if tuple(sd[key].shape) == _file_shape(p, t) else None
        if leaf is None:
            skipped.append(key)
            continue
        state[key] = leaf
        loaded.append(key)
    unused = sorted(set(sd) - set(loaded) - set(skipped))
    total = len(loaded) + len(skipped) + len(missing)
    if skipped or missing:
        warnings.warn(
            f"Transfer load from '{path}': {len(loaded)}/{total} leaves loaded; "
            f"shape-mismatch (kept fresh init): {skipped[:6]}{'...' if len(skipped) > 6 else ''}; "
            f"missing: {missing[:4]}",
            RuntimeWarning,
        )
    model.load_state_dict(state, strict=False)
    return {"loaded": len(loaded), "total": total, "skipped": skipped, "missing": missing, "unused_src": unused}
