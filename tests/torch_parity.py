"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU (tests/conftest.py) and the port runs on the CPU too, where each
kernel wrapper takes its plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the tier-1 run uses several pytest workers


def randomize_bn(tree, rng: np.random.RandomState):
    """A copy of a JAX params tree with non-trivial BN statistics, so that
    folding is exercised (fresh init has scale 1, bias 0, mean 0, var 1)."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            c = np.asarray(tree["scale"]).shape
            return {
                "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": (rng.randn(*c) * 0.1).astype(np.float32),
                "mean": (rng.randn(*c) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
            }
        return {k: randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [randomize_bn(v, rng) for v in tree]
    return np.asarray(tree)


def nhwc_to_torch(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> NCHW torch (the port's block layout)."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).to(dtype)


def torch_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def as_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32) if not torch.is_tensor(x) else x.detach().float().numpy()


def bf16_ulps(ref: np.ndarray, n: float) -> float:
    """n bf16 ulps (2^-8 relative) of the largest magnitude in `ref` (at least 1)."""
    return n * 2.0 ** -8 * max(1.0, float(np.max(np.abs(ref))))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")
