"""Flat torch state dict (official or lean) -> a YOLOv10 module's state.

Counterpart of the JAX package's `leanyolo_tpu/models/yolov10/remap.py`.
The port's modules already carry the torch names and the OIHW layout of
official and lean `.pt` files (convert.py), so no kernel is transposed here;
what remains is JAX's three passes, walked in the JAX tree's leaf order
(`convert.module_leaves`), so that the in-order shape fill and the order of
every statistics list are JAX's:

1. normalise the source keys (step counters and `dfl.bins` skipped), apply
   the keymap for official files, rename fused-RepVGGDW spellings only where
   the module lacks the direct name, then match exact names;
2. synthesise RepVGGDW `conv1` branches of a fused file as a zero conv and
   an identity BN;
3. unless strict, fill the rest in order from the unused source tensors, by
   shape.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .convert import module_leaves, path_to_torch_key
from .keymap import REPVGGDW_FUSED_ALT, official_key_to_lean

_INPUT_NORMS = (("input_subtract",), ("input_divide",))


def convert_leaf(src: Any, dst_shape: torch.Size, path: Tuple) -> Optional[torch.Tensor]:
    """One source tensor as an fp32 CPU tensor of `dst_shape`; None if it has
    another shape. The input norms are taken flat (`[1, C, 1, 1]` or `[C]`)."""
    t = src.detach().cpu() if torch.is_tensor(src) else torch.from_numpy(np.array(src))
    t = t.float()
    if path in _INPUT_NORMS:
        t = t.reshape(-1)
    return t if tuple(t.shape) == tuple(dst_shape) else None


def torch_sd_to_state(
    src_sd: Dict[str, Any],
    module: nn.Module,
    *,
    official: bool = False,
    strict: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Convert a flat torch state dict into a full state dict for `module`.

    Args:
        src_sd: dotted name -> tensor (torch tensors or numpy arrays). With
            `official=True` the keys use the official `model.{idx}.`
            numbering and go through the keymap first.
        module: the YOLOv10 module whose names, shapes and leaf order rule;
            its own values fill whatever the source does not.
        strict: raise when any module leaf is missing or any source tensor
            is unused.

    Returns:
        (state, stats): `state` maps every key of `module.state_dict()` to an
        fp32 CPU tensor, ready for `module.load_state_dict`; `stats` holds the
        JAX function's 'matched', 'synthesized', 'shape_filled', 'missing'
        and 'unused_src' lists, in its order, and 'src_total'.
    """
    src: Dict[str, Any] = {}
    for k, v in src_sd.items():
        if not hasattr(v, "shape"):
            continue
        if k.endswith("num_batches_tracked") or k.endswith("dfl.bins"):
            continue  # step counters / derived buffers have no module counterpart
        lean = official_key_to_lean(k) if official else k
        if lean is None:
            continue
        src[lean] = v

    leaves = module_leaves(module)

    if official:
        # Fused RepVGGDW spellings -> unfused names, only where the module
        # lacks the direct name: a plain CIB also has `cv1.2.conv.weight`,
        # and that one must not be renamed.
        template_keys = {path_to_torch_key(p) for p, _ in leaves}
        template_keys.discard(None)
        for fused_suf, unfused_suf in REPVGGDW_FUSED_ALT.items():
            for k in list(src.keys()):
                if k.endswith(fused_suf) and k not in template_keys:
                    cand = k[: -len(fused_suf)] + unfused_suf
                    if cand in template_keys:
                        src.setdefault(cand, src.pop(k))

    state = {path_to_torch_key(p): t.detach().cpu().float().clone() for p, t in leaves}
    matched, synthesized, shape_filled, missing = [], [], [], []
    used_src = set()

    # Pass 1: exact name matches.
    unmatched: List[Tuple[Tuple, torch.Tensor]] = []
    for path, leaf in leaves:
        tk = path_to_torch_key(path)
        if tk is not None and tk in src:
            conv = convert_leaf(src[tk], leaf.shape, path)
            if conv is not None:
                state[tk] = conv
                matched.append(tk)
                used_src.add(tk)
                continue
        unmatched.append((path, leaf))

    # Pass 2: synthesise fused-RepVGGDW conv1 branches (zero conv + identity BN).
    still: List[Tuple[Tuple, torch.Tensor]] = []
    for path, leaf in unmatched:
        spath = [str(c) for c in path]
        if "conv1" in spath:
            i = spath.index("conv1")
            base_key = path_to_torch_key(tuple(path[:i]) + ("conv",) + path[i + 1:])
            if base_key in used_src or base_key in src:
                name = path[-1]
                parent = str(path[-2]) if len(path) > 1 else ""
                if parent == "conv" and name == "w":
                    value = torch.zeros(leaf.shape)
                elif parent == "bn" and name in ("scale", "var"):
                    value = torch.ones(leaf.shape)
                elif parent == "bn":
                    value = torch.zeros(leaf.shape)
                else:
                    still.append((path, leaf))
                    continue
                state[path_to_torch_key(path)] = value
                synthesized.append(".".join(spath))
                continue
        still.append((path, leaf))

    # Pass 3: in-order shape fill from the unused source tensors.
    if still and not strict:
        remaining_src = [(k, v) for k, v in src.items() if k not in used_src]
        si = 0
        for path, leaf in list(still):
            want: Optional[torch.Tensor] = None
            while si < len(remaining_src):
                k, v = remaining_src[si]
                conv = convert_leaf(v, leaf.shape, path)
                si += 1
                if conv is not None:
                    want = conv
                    used_src.add(k)
                    break
            if want is not None:
                state[path_to_torch_key(path)] = want
                shape_filled.append(path_to_torch_key(path))
                still.remove((path, leaf))

    for path, _ in still:
        if official and path in _INPUT_NORMS:
            # Official release files carry no normalization constants: these
            # leaves are the configuration's (get_model) and keep their values.
            continue
        missing.append(path_to_torch_key(path))

    unused_src = [k for k in src if k not in used_src]
    stats = {
        "matched": matched,
        "synthesized": synthesized,
        "shape_filled": shape_filled,
        "missing": missing,
        "unused_src": unused_src,
        "src_total": len(src),
    }
    if strict and (missing or unused_src):
        raise ValueError(
            f"strict load failed: {len(missing)} missing leaves "
            f"(e.g. {missing[:5]}), {len(unused_src)} unused source tensors "
            f"(e.g. {sorted(unused_src)[:5]})"
        )
    return state, stats


def params_to_torch_sd(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A YOLOv10 module's lean torch state dict (JAX `params_to_torch_sd`):
    dotted names in the JAX tree's leaf order, conv kernels OIHW, the input
    norms as `[1, C, 1, 1]`; CPU tensors of the module's dtypes."""
    out: Dict[str, torch.Tensor] = {}
    for path, t in module_leaves(module):
        t = t.detach().cpu().clone()
        out[path_to_torch_key(path)] = t.reshape(1, -1, 1, 1) if path in _INPUT_NORMS else t
    return out
