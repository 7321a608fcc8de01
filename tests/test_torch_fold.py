"""The port's fold (leanyolo_tpu_torch/models/yolov10/fold.py) against JAX `fold_params`.

Both fold in fp32 with the same elementwise operations, so the folded
tensors agree to fp32 rounding (< 1e-6 relative); the bf16 cast after
folding rounds to nearest even on both sides and agrees bit for bit where
the fp32 values do (at most one bf16 ulp apart otherwise).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10.fold import fold_params
from leanyolo_tpu.models.yolov10.model import YOLOv10 as JYOLOv10
from leanyolo_tpu_torch.models.yolov10 import layers as TL
from leanyolo_tpu_torch.models.yolov10.convert import flatten_param_paths, load_jax_params, path_to_torch_key
from leanyolo_tpu_torch.models.yolov10.fold import fold_model
from leanyolo_tpu_torch.models.yolov10.model import YOLOv10 as TYOLOv10
from torch_parity import randomize_bn


def _pair(name: str, **norm):
    jm = JYOLOv10.create(name, class_names=[f"c{i}" for i in range(4)], seed=3, **norm)
    params = randomize_bn(jm.params, np.random.RandomState(3))
    tm = TYOLOv10.create(name, class_names=jm.class_names, **norm)
    return params, load_jax_params(tm, params)


def _jax_folded_sd(tree):
    out = {}
    for path, leaf in flatten_param_paths(tree):
        arr = np.asarray(leaf).astype(np.float32)
        if path[-1] == "w" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[path_to_torch_key(path)] = arr
    return out


@pytest.mark.parametrize("name,norm", [
    ("yolov10n", {}),
    ("yolov10s", {"input_norm_subtract": (10.0, 20.0, 30.0), "input_norm_divide": (50.0, 60.0, 70.0)}),
])
def test_fold_matches_fold_params(name, norm):
    params, model = _pair(name, **norm)
    ref = _jax_folded_sd(fold_params(params))
    folded = fold_model(model)
    got = {k: v.detach().float().numpy() for k, v in folded.state_dict().items()}
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k], r, rtol=1e-6, atol=1e-6 * max(1.0, float(np.abs(r).max())), err_msg=k)
    # The folded tree also loads strictly into the folded module tree.
    load_jax_params(fold_model(model), fold_params(params))


def test_fold_bf16_cast_matches():
    import jax.numpy as jnp

    params, model = _pair("yolov10n")
    ref = fold_params(params, dtype=jnp.bfloat16)
    folded = fold_model(model, dtype=torch.bfloat16)
    sd = folded.state_dict()
    for path, leaf in flatten_param_paths(ref):
        t = sd[path_to_torch_key(path)]
        assert t.dtype == torch.bfloat16
        r = torch.from_numpy(np.asarray(leaf).astype(np.float32))
        if path[-1] == "w" and r.ndim == 4:
            r = r.permute(3, 2, 0, 1)
        diff = (t.float() - r).abs()
        assert float(diff.max()) <= 2.0 ** -8 * max(1.0, float(r.abs().max())), path


def test_fold_structure_and_idempotence():
    _, model = _pair("yolov10s")
    folded = fold_model(model)
    fused = [m for m in folded.modules() if isinstance(m, TL.FusedRepVGGDW)]
    assert len(fused) == 2  # backbone c8 and neck p4_p5 (use_lk_c8, use_lk_p4_p5)
    assert not any(type(m) is TL.RepVGGDW for m in folded.modules())
    assert all(m.folded for m in folded.modules() if isinstance(m, TL.ConvBNAct))
    assert torch.all(folded.input_subtract == 0) and torch.all(folded.input_divide == 1)
    again = fold_model(folded)
    for (k, a), (_, b) in zip(folded.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    # The source model is untouched.
    assert not any(m.folded for m in model.modules() if isinstance(m, TL.ConvBNAct))
