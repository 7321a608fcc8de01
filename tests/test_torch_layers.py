"""Port blocks (leanyolo_tpu_torch/models/yolov10/layers.py) against the JAX blocks.

Each block gets the same JAX parameters (BN statistics randomized) and the
same NHWC input, made with numpy from a seed. fp32: unfolded and folded both
agree to < 5e-4 of the output scale. bf16 (folded, weights cast after
folding as the serving path does): both sides round at the same points but
sum in another order, so a rounding may land one bf16 ulp (2^-8 relative)
apart and carry through the block's few layers; the limit is 8 ulps of the
output's largest magnitude.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leanyolo_tpu.models.yolov10 import layers as JL
from leanyolo_tpu.models.yolov10.fold import fold_params
from leanyolo_tpu_torch.models.yolov10 import layers as TL
from leanyolo_tpu_torch.models.yolov10.convert import load_jax_params
from leanyolo_tpu_torch.models.yolov10.fold import fold_module
from torch_parity import as_f32, bf16_ulps, nhwc_to_torch, randomize_bn, torch_to_nhwc

# name: (jax init, jax apply kwargs-bound, torch module factory, input NHWC shapes)
BLOCKS = {
    "cba3x3": (lambda k: JL.cba_init(k, 8, 16, 3), functools.partial(JL.cba_apply),
               lambda: TL.ConvBNAct(8, 16, 3), [(2, 8, 8, 8)]),
    "cba_dw_s2_noact": (lambda k: JL.cba_init(k, 16, 16, 3, groups=16),
                        functools.partial(JL.cba_apply, stride=2, groups=16, act=False),
                        lambda: TL.ConvBNAct(16, 16, 3, stride=2, groups=16, act=False), [(2, 8, 8, 16)]),
    "bottleneck": (lambda k: JL.bottleneck_init(k, 16, 16), functools.partial(JL.bottleneck_apply, shortcut=True),
                   lambda: TL.Bottleneck(16, 16, shortcut=True), [(2, 8, 8, 16)]),
    "c2f": (lambda k: JL.c2f_init(k, 16, 32, 2), functools.partial(JL.c2f_apply, shortcut=False),
            lambda: TL.C2f(16, 32, 2, shortcut=False), [(2, 8, 8, 16)]),
    "c2f_upcat": (lambda k: JL.c2f_init(k, 24, 32, 1), functools.partial(JL.c2f_apply, shortcut=False),
                  lambda: TL.C2f(24, 32, 1, shortcut=False), [(2, 4, 4, 16), (2, 8, 8, 8)]),
    "sppf": (lambda k: JL.sppf_init(k, 32, 32), JL.sppf_apply, lambda: TL.SPPF(32, 32), [(2, 8, 8, 32)]),
    "repvggdw": (lambda k: JL.repvggdw_init(k, 16), JL.repvggdw_apply, lambda: TL.RepVGGDW(16), [(2, 8, 8, 16)]),
    "cib_lk": (lambda k: JL.cib_init(k, 16, 16, 1.0, lk=True), functools.partial(JL.cib_apply, shortcut=True, lk=True),
               lambda: TL.CIB(16, 16, shortcut=True, lk=True), [(2, 8, 8, 16)]),
    "cib": (lambda k: JL.cib_init(k, 16, 16, 1.0, lk=False), functools.partial(JL.cib_apply, shortcut=True, lk=False),
            lambda: TL.CIB(16, 16, shortcut=True, lk=False), [(2, 8, 8, 16)]),
    "c2fcib_upcat": (lambda k: JL.c2fcib_init(k, 24, 32, 1, lk=True),
                     functools.partial(JL.c2fcib_apply, shortcut=True, lk=True),
                     lambda: TL.C2f(24, 32, 1, shortcut=True, lk=True), [(2, 4, 4, 16), (2, 8, 8, 8)]),
    "attention": (lambda k: JL.attention_init(k, 128, 2), functools.partial(JL.attention_apply, num_heads=2),
                  lambda: TL.Attention(128, 2), [(2, 4, 4, 128)]),
    "psa": (lambda k: JL.psa_init(k, 256), JL.psa_apply, lambda: TL.PSA(256), [(2, 4, 4, 256)]),
    "scdown": (lambda k: JL.scdown_init(k, 16, 32), JL.scdown_apply, lambda: TL.SCDown(16, 32), [(2, 8, 8, 16)]),
}


def _case(name: str, seed: int = 0):
    jinit, japply, tfactory, shapes = BLOCKS[name]
    rng = np.random.RandomState(seed)
    params = randomize_bn(jinit(jax.random.PRNGKey(seed)), rng)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    module = load_jax_params(tfactory(), params).eval()
    return params, japply, module, xs


def _run_jax(apply, params, xs, dtype):
    args = [jnp.asarray(x, dtype) for x in xs]
    x = tuple(args) if len(args) > 1 else args[0]
    return as_f32(jax.jit(lambda p, x: apply(p, x))(params, x))


def _run_torch(module, xs, dtype):
    args = [nhwc_to_torch(x, dtype) for x in xs]
    with torch.no_grad():
        y = module(tuple(args) if len(args) > 1 else args[0])
    return torch_to_nhwc(y)


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_block_fp32(name, folded):
    params, apply, module, xs = _case(name)
    if folded:
        params, module = fold_params(params), fold_module(module)
        assert all(m.bn is None for m in module.modules() if isinstance(m, TL.ConvBNAct))
    ref = _run_jax(apply, params, xs, jnp.float32)
    got = _run_torch(module, xs, torch.float32)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref))
    assert err < 5e-4 * max(1.0, np.max(np.abs(ref))), err


@pytest.mark.parametrize("name", ["c2f_upcat", "cib_lk", "attention", "psa", "scdown"])
def test_block_bf16_folded(name):
    params, apply, module, xs = _case(name, seed=1)
    ref = _run_jax(apply, fold_params(params, dtype=jnp.bfloat16), xs, jnp.bfloat16)
    got = _run_torch(fold_module(module).to(torch.bfloat16), xs, torch.bfloat16)
    err = np.max(np.abs(got - ref))
    assert err <= bf16_ulps(ref, 8), (err, np.max(np.abs(ref)))


def test_repvggdw_folds_to_fused_block():
    _, _, module, xs = _case("repvggdw")
    fused = fold_module(module)
    assert isinstance(fused, TL.FusedRepVGGDW) and tuple(fused.conv.weight.shape) == (16, 1, 7, 7)
    unfused = _run_torch(module, xs, torch.float32)
    assert np.max(np.abs(_run_torch(fused, xs, torch.float32) - unfused)) < 5e-4 * max(1.0, np.max(np.abs(unfused)))


def test_fused_repvggdw_packs_its_weights_once():
    """`w49` ([49, C], the dw7x7 kernel's layout) stays out of the state dict,
    follows a cast, and is packed again after a state-dict load."""
    from leanyolo_tpu_torch.kernels import dwconv

    _, _, module, xs = _case("repvggdw")
    fused = fold_module(module)
    assert "w49" not in fused.state_dict()
    assert torch.equal(fused.w49, dwconv.pack_weights(fused.conv.weight))
    sd = {k: torch.randn_like(v) for k, v in fused.state_dict().items()}
    fused.load_state_dict(sd)
    assert torch.equal(fused.w49, sd["conv.weight"].reshape(16, 49).t())
    assert fused.to(torch.bfloat16).w49.dtype == torch.bfloat16
