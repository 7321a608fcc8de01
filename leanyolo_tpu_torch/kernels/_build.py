"""Builds the kernels in `csrc/` at first use, in one `cpp_extension.load` call.

The CUDA sources include no PyTorch header; `binding.cpp`, the one file
that does, is compiled by the host compiler. Everything lands in
`build/kernels/` at the repository root (git-ignored). A failed build
raises.
"""

from __future__ import annotations

import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("binding.cpp", "stem.cu", "stem_tc.cu", "dw7x7.cu", "topk.cu", "mpbwd.cu", "s2dconv.cu", "matmul.cu",
           "argmax.cu", "nms.cu")
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

_ext = None
build_seconds = None


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

