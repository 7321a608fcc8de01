"""Carry a JAX parameter tree across into the port's modules.

The JAX package's parameter tree mirrors the module tree, and the port's
modules are named after it, so the conversion is a name table
(`leanyolo_tpu/models/yolov10/remap.py:32-64`, `:243-261`): tree paths join
with dots, conv `w` -> `weight`, `b` -> `bias`, BN `scale`/`bias`/`mean`/`var`
-> `weight`/`bias`/`running_mean`/`running_var`, and conv kernels go from
HWIO to OIHW. Both the unfolded tree and a folded one (`fold_params`) load,
into an unfolded or a folded model respectively. `export_jax_params` is the
inverse: the module's parameters and BN statistics as the JAX-shaped numpy
tree, in the JAX tree's leaf order (`jax_order`), which checkpoint remapping
walks (remap.py).
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


def _module_tree(module: nn.Module, leaf) -> Any:
    """`module`'s parameters and buffers as a JAX-shaped tree (nested dicts and
    lists, the module's own order) of `leaf(tensor)`."""
    if isinstance(module, L.Conv):
        out = {"w": leaf(module.weight)}
        if module.bias is not None:
            out["b"] = leaf(module.bias)
        return out
    if isinstance(module, L.BatchNorm):
        return {"scale": leaf(module.weight), "bias": leaf(module.bias), "mean": leaf(module.running_mean),
                "var": leaf(module.running_var)}
    if isinstance(module, nn.ModuleList):
        return [_module_tree(c, leaf) for c in module]
    out = {name: _module_tree(c, leaf) for name, c in module.named_children() if c is not None}
    for name in ("input_subtract", "input_divide"):
        if name in dict(module.named_buffers(recurse=False)):
            out[name] = leaf(getattr(module, name))
    return out


# The JAX backbone's dict order: `backbone_init` adds c6 and c8 after psa10
# (leanyolo_tpu/models/yolov10/model.py:38-55).
_JAX_BACKBONE_ORDER = ("cv0", "cv1", "c2", "cv3", "c4", "sc5", "sc7", "sppf9", "psa10", "c6", "c8")


def _sorted_dicts(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _sorted_dicts(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted_dicts(v) for v in tree]
    return tree


def jax_order(tree: Any) -> Any:
    """A model's JAX-shaped tree re-ordered as the JAX package orders it
    (`model_init`): backbone, neck, head, then the input norms; the
    backbone's nodes in `_JAX_BACKBONE_ORDER`; and every dict under the
    one2one head branches in sorted key order, since `head_init` makes them
    with `jax.tree_util.tree_map`, which rebuilds dicts with sorted keys.
    Official checkpoints are remapped in this order (its shape fill and its
    statistics follow it)."""
    bb, head = tree["backbone"], tree["head"]
    out = {"backbone": {k: bb[k] for k in _JAX_BACKBONE_ORDER}, "neck": tree["neck"],
           "head": {k: _sorted_dicts(v) if k.startswith("one2one") else v for k, v in head.items()}}
    for name in ("input_subtract", "input_divide"):
        if name in tree:
            out[name] = tree[name]
    return out


def module_leaves(module: nn.Module) -> List[Tuple[Tuple, torch.Tensor]]:
    """(JAX tree path, the module's own tensor) pairs of a YOLOv10 module, in
    the JAX tree's leaf order; `path_to_torch_key(path)` is the tensor's
    state-dict key."""
    return flatten_param_paths(jax_order(_module_tree(module, lambda t: t)))


def export_jax_params(module: nn.Module) -> Any:
    """The inverse of `load_jax_params`: a YOLOv10 module's parameters and
    buffers as a JAX-shaped tree of fp32 numpy arrays (nested dicts and
    lists, in the JAX tree's order; conv kernels OIHW -> HWIO).
    `load_jax_params(copy, export_jax_params(m))` restores m's state exactly.
    """

    def arr(t: torch.Tensor) -> np.ndarray:
        a = t.detach().float().cpu().numpy().copy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    return jax_order(_module_tree(module, arr))
