"""Safe torch-checkpoint reading into flat state dicts of CPU tensors.

The official YOLOv10 checkpoints pickle ultralytics model objects. They are
loaded with `torch.load(weights_only=True)` and a loop that allowlists each
missing global as a bare stub class, so no third-party code is imported or
run. Counterpart of the JAX package's `leanyolo_tpu/utils/torch_reader.py`,
which returns numpy arrays; here the values stay torch tensors, with the
same upcast: floating tensors become fp32, integer ones keep their dtype.

It also unwraps checkpoint containers: wrapper keys like
'model'/'state_dict'/'ema_state_dict', module-like objects traversed through
`_parameters`/`_buffers`/`_modules` without calling methods, and common
prefix stripping.
"""

from __future__ import annotations

import re
import sys
import types
from typing import Any, Dict

import torch

POSSIBLE_STATE_KEYS = ("state_dict", "model", "ema_state_dict", "model_state", "net")
COMMON_PREFIXES = ("module.", "model.model.", )


def _safe_load_with_stubs(path: str):
    """torch.load(weights_only=True), stubbing unknown globals on demand.

    The stubs stay registered (in `sys.modules` and torch's safe globals), so
    a later load of a file naming the same class finds them at once.
    """
    from torch.serialization import add_safe_globals

    attempted = set()
    for _ in range(64):
        try:
            return torch.load(path, map_location="cpu", weights_only=True)
        except Exception as ex:
            msg = str(ex)
            m = re.search(r"Unsupported global: (?:GLOBAL\s+)?([\w\.]+)\.(\w+)", msg)
            if not m:
                raise
            mod_path, cls_name = m.group(1), m.group(2)
            fqcn = f"{mod_path}.{cls_name}"
            if fqcn in attempted:
                raise
            attempted.add(fqcn)
            parent = None
            parts = mod_path.split(".")
            for i, part in enumerate(parts):
                full = ".".join(parts[: i + 1])
                mod = sys.modules.get(full)
                if mod is None:
                    mod = types.ModuleType(full)
                    sys.modules[full] = mod
                    if parent is not None:
                        setattr(parent, part, mod)
                parent = mod
            mod = sys.modules[mod_path]
            if not hasattr(mod, cls_name):
                stub = type(cls_name, (object,), {"__module__": mod_path, "state_dict": lambda self: {}})
                setattr(mod, cls_name, stub)
                add_safe_globals([stub])
            else:
                add_safe_globals([getattr(mod, cls_name)])
    raise RuntimeError("failed to safely load checkpoint with dynamic stubs")


def _module_like_to_state_dict(mod: Any, prefix: str = "") -> Dict[str, Any]:
    """Extract tensors from an nn.Module-like object without calling methods."""
    out: Dict[str, Any] = {}
    try:
        for attr in ("_parameters", "_buffers"):
            d = getattr(mod, attr, None)
            if isinstance(d, dict):
                for k, v in d.items():
                    if isinstance(v, torch.Tensor):
                        out[prefix + k] = v
        children = getattr(mod, "_modules", None)
        if isinstance(children, dict):
            for name, child in children.items():
                child_prefix = prefix + (name + "." if prefix or name else "")
                out.update(_module_like_to_state_dict(child, child_prefix))
    except Exception:  # a stub object of any shape: take what was found
        pass
    return out


def _state_dict_of(obj: Any) -> Dict[str, Any]:
    """obj.state_dict() where obj has one that returns a non-empty dict, else {}."""
    if hasattr(obj, "state_dict") and callable(getattr(obj, "state_dict")):
        try:
            sd = obj.state_dict()
            if isinstance(sd, dict) and sd:
                return sd
        except Exception:  # an unpickled object's method may fail in any way
            pass
    return {}


def extract_state_dict(obj: Any) -> Dict[str, Any]:
    """Unwrap checkpoint containers to a flat name -> tensor dict."""
    sd = _state_dict_of(obj) or _module_like_to_state_dict(obj)
    if sd:
        return sd
    if isinstance(obj, dict):
        for key in POSSIBLE_STATE_KEYS:
            v = obj.get(key)
            if v is None:
                continue
            sd = _state_dict_of(v) or _module_like_to_state_dict(v)
            if sd:
                return sd
            if isinstance(v, dict) and v:
                inner = v
                for key2 in POSSIBLE_STATE_KEYS:
                    vv = inner.get(key2)
                    sd = _state_dict_of(vv) or _module_like_to_state_dict(vv)
                    if sd:
                        return sd
                    if isinstance(vv, dict) and vv:
                        inner = vv
                        break
                return inner
        return obj
    return obj


def to_cpu_sd(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Tensors to the CPU, floating ones as fp32; anything else dropped."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            out[k] = t.float() if t.is_floating_point() else t
    return out


def strip_common_prefixes(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip 'module.' / 'model.model.' wrappers.

    The official `model.{idx}.` numbering is kept because the keymap
    consumes it directly.
    """
    out = {}
    for k, v in sd.items():
        kk = k
        changed = True
        while changed:
            changed = False
            for p in COMMON_PREFIXES:
                if kk.startswith(p):
                    kk = kk[len(p):]
                    changed = True
        out[kk] = v
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load any torch checkpoint into a flat state dict of CPU tensors."""
    obj = _safe_load_with_stubs(path)
    sd = extract_state_dict(obj)
    return strip_common_prefixes(to_cpu_sd(sd))
