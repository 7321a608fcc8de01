"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each wrapper module (stem.py, dwconv.py, topk.py, mpbwd.py, s2dconv.py,
matmul.py, argmax.py, nms.py, dfl.py, bnstats.py, tal.py) holds a kernel's
wrapper and, beside it, a plain PyTorch version of the same function
(gather.py holds the level gather's plain version alone: on the card it is
the fused second top-k's key builder, topk.py `topk_decode`; flags.py the
layout of the decodes' non-finite flags). Each wrapper
but the training path's (mpbwd's, bnstats's and tal's) is a PyTorch
operator, `leanyolo_tpu_torch::<name>` (_build.operator), and the
dispatcher picks by the devices of its tensors: CPU tensors take the plain
version; CUDA tensors launch the kernel, which is built from `csrc/` at
first use (_build.py), or raise; tracing (`torch.export`) takes a fake
implementation that gives the output shapes. Nothing falls back from one
to the other.

`LAUNCHES` counts kernel launches per kernel; a wrapper adds one where it
launches its kernel and nowhere else. `stem`, `s2dconv`, `bmm` and
`mpbwd`, `bn_moments` and `bn_moments_bwd` count both routes of their
kernel; `stem_tc` (the tensor-core stem), `s2dconv_wgmma` and `bmm_wgmma`
(the wgmma routes) the bf16 route alone, `mpbwd_vec`, `bn_moments_vec` and
`bn_moments_bwd_vec` the 16-byte routes. `topk` counts the top-k
decode's fused second top-k too, and `topk_decode` that launch alone;
`argmax` counts the max/argmax launch that also writes the non-finite
flags (`max_argmax_flags`). The assignment's one wrapper (tal.py)
launches two kernels and counts each: `tal_candidates` and `tal_targets`.
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {"stem": 0, "stem_tc": 0, "dw7x7": 0, "topk": 0, "mpbwd": 0, "mpbwd_vec": 0,
                            "s2dconv": 0, "s2dconv_wgmma": 0, "bmm": 0, "bmm_wgmma": 0,
                            "argmax": 0, "nms": 0, "dfl_boxes": 0, "topk_decode": 0,
                            "bn_moments": 0, "bn_moments_vec": 0, "bn_moments_bwd": 0, "bn_moments_bwd_vec": 0,
                            "tal_candidates": 0, "tal_targets": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
