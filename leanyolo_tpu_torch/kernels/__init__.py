"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each wrapper module (stem.py, dwconv.py, topk.py, mpbwd.py, s2dconv.py,
matmul.py, argmax.py, nms.py) holds a kernel's wrapper and, beside it, a
plain PyTorch version of the same function. Each wrapper but mpbwd's is a
PyTorch operator, `leanyolo_tpu_torch::<name>` (_build.operator), and the
dispatcher picks by the devices of its tensors: CPU tensors take the plain
version; CUDA tensors launch the kernel, which is built from `csrc/` at
first use (_build.py), or raise; tracing (`torch.export`) takes a fake
implementation that gives the output shapes. Nothing falls back from one
to the other.

`LAUNCHES` counts kernel launches per kernel; a wrapper adds one where it
launches its kernel and nowhere else. `stem`, `s2dconv`, `bmm` and
`mpbwd` count both routes of their kernel; `stem_tc` (the tensor-core
stem), `s2dconv_wgmma` and `bmm_wgmma` (the wgmma routes) the bf16 route
alone, `mpbwd_vec` mpbwd's 16-byte route.
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {"stem": 0, "stem_tc": 0, "dw7x7": 0, "topk": 0, "mpbwd": 0, "mpbwd_vec": 0,
                            "s2dconv": 0, "s2dconv_wgmma": 0, "bmm": 0, "bmm_wgmma": 0,
                            "argmax": 0, "nms": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
