"""Builds the kernels in `csrc/` at first use, in one `cpp_extension.load`
call, and registers each kernel wrapper as a PyTorch operator.

The CUDA sources include no PyTorch header; `binding.cpp`, the one file
that does, is compiled by the host compiler. Everything lands in
`build/kernels/` at the repository root (git-ignored). A failed build
raises.

`operator` defines `leanyolo_tpu_torch::<name>` with three
implementations: CPU (the plain version), CUDA (the wrapper body that
launches the kernel) and fake (output shapes and dtypes, for
`torch.export` and other tracing; it touches no data). The dispatcher picks
by the devices of the tensor arguments, so a wrapper is one call through
its operator, and an exported program names the operator, which loads
once this package's kernels are imported.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("binding.cpp", "stem.cu", "stem_tc.cu", "dw7x7.cu", "topk.cu", "mpbwd.cu", "s2dconv.cu", "matmul.cu",
           "argmax.cu", "nms.cu", "decode.cu", "bnstats.cu", "tal.cu")
CUDA_FLAGS = [
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    # load() defines the no-conversion macros; the sources use the
    # intrinsics anyway, so undefining them only widens what compiles.
    "-U__CUDA_NO_HALF_OPERATORS__",
    "-U__CUDA_NO_HALF_CONVERSIONS__",
    "-U__CUDA_NO_BFLOAT16_CONVERSIONS__",
    "-U__CUDA_NO_HALF2_OPERATORS__",
]

NAMESPACE = "leanyolo_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")

_ext = None
build_seconds = None


def operator(name: str, schema: str, *, cpu: Callable, cuda: Callable, fake: Callable):
    """Define `leanyolo_tpu_torch::<name><schema>` with its CPU, CUDA and
    fake implementations; returns the operator's overload to call."""
    _LIB.define(name + schema)
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def ext():
    """The compiled extension module (built on the first call)."""
    global _ext, build_seconds
    if _ext is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _ext = load(
            name="leanyolo_tpu_torch_kernels",
            sources=[str(_CSRC / s) for s in SOURCES],
            build_directory=str(BUILD_DIR),
            extra_cflags=["-O3", "-std=c++17"],
            extra_cuda_cflags=CUDA_FLAGS,
        )
        build_seconds = time.perf_counter() - t0
    return _ext


def check_cuda(t, name: str) -> None:
    """Raise unless `t` is a contiguous CUDA tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")

