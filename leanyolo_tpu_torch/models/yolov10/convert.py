"""Carry a JAX parameter tree across into the port's modules.

The JAX package's parameter tree mirrors the module tree, and the port's
modules are named after it, so the conversion is a name table
(`leanyolo_tpu/models/yolov10/remap.py:32-64`, `:243-261`): tree paths join
with dots, conv `w` -> `weight`, `b` -> `bias`, BN `scale`/`bias`/`mean`/`var`
-> `weight`/`bias`/`running_mean`/`running_var`, and conv kernels go from
HWIO to OIHW. Both the unfolded tree and a folded one (`fold_params`) load,
into an unfolded or a folded model respectively. `export_jax_params` is the
inverse: the module's parameters and BN statistics as the JAX-shaped numpy
tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from . import layers as L

_BN_LEAF_TO_TORCH = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def flatten_param_paths(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """Flatten a params tree into (path, leaf) pairs; lists use int components."""
    out: List[Tuple[Tuple, Any]] = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(flatten_param_paths(v, prefix + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(flatten_param_paths(v, prefix + (i,)))
    else:
        out.append((prefix, tree))
    return out


def path_to_torch_key(path: Tuple) -> Optional[str]:
    """Tree path -> dotted module key (None = no counterpart)."""
    comps = [str(c) for c in path]
    leaf = comps[-1]
    parent = comps[-2] if len(comps) > 1 else ""
    if parent == "bn":
        if leaf not in _BN_LEAF_TO_TORCH:
            return None
        comps[-1] = _BN_LEAF_TO_TORCH[leaf]
    elif leaf == "w":
        comps[-1] = "weight"
    elif leaf == "b":
        comps[-1] = "bias"
    elif path in (("input_subtract",), ("input_divide",)):
        return comps[0]
    else:
        return None
    return ".".join(comps)


def _to_tensor(leaf: Any) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # a bf16 leaf of a cast tree: exact through fp32
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def load_jax_params(module: nn.Module, params: Any) -> nn.Module:
    """Load a JAX parameter tree (nested dicts/lists of numpy arrays) into `module`.

    Strict: every leaf must map to a parameter or buffer of `module` with the
    same shape, and every parameter and buffer must be covered; anything else
    raises. The loaded tensors keep the tree's dtypes. Returns `module`.
    """
    own = module.state_dict()
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in flatten_param_paths(params):
        key = path_to_torch_key(path)
        if key is None:
            raise KeyError(f"parameter leaf with no module counterpart: {'/'.join(map(str, path))}")
        t = _to_tensor(leaf)
        if path[-1] == "w" and t.ndim == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        sd[key] = t.contiguous()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"strict load failed: {len(missing)} missing (e.g. {missing[:5]}), "
                       f"{len(extra)} unexpected (e.g. {extra[:5]})")
    for key, t in sd.items():
        if tuple(t.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch at {key}: tree {tuple(t.shape)} vs module {tuple(own[key].shape)}")
        sd[key] = t.to(own[key].device)
    module.load_state_dict(sd, strict=True, assign=True)
    return module


def export_jax_params(module: nn.Module) -> Any:
    """The inverse of `load_jax_params`: `module`'s parameters and buffers as
    a JAX-shaped tree of fp32 numpy arrays (nested dicts and lists; conv
    kernels OIHW -> HWIO). `load_jax_params(copy, export_jax_params(m))`
    restores m's state exactly.
    """

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy().copy()

    def walk(m: nn.Module) -> Any:
        if isinstance(m, L.Conv):
            out = {"w": arr(m.weight).transpose(2, 3, 1, 0)}
            if m.bias is not None:
                out["b"] = arr(m.bias)
            return out
        if isinstance(m, L.BatchNorm):
            return {"scale": arr(m.weight), "bias": arr(m.bias), "mean": arr(m.running_mean),
                    "var": arr(m.running_var)}
        if isinstance(m, nn.ModuleList):
            return [walk(c) for c in m]
        out = {name: walk(c) for name, c in m.named_children() if c is not None}
        for name in ("input_subtract", "input_divide"):
            if hasattr(m, name) and name in dict(m.named_buffers(recurse=False)):
                out[name] = arr(getattr(m, name))
        return out

    return walk(module)
