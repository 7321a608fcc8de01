"""Exact per-row top-k over the last dim: CUDA kernel (csrc/topk.cu) and plain version.

Replaces the JAX package's hand-shaped lax program
`leanyolo_tpu/ops/topk.py:69 _topk_packed_bf16` (and its fp32 route,
`topk.py:146-167`). Order: value descending, then index ascending. Every
element becomes one unique integer key whose descending order is exactly
that order, so the top k keys are the answer and no tie is left to a
sort's whim:

- bf16 rows of at most 32768: the s32 key of `topk.py:37-66`, the value's
  order-preserving 16 bits high and the complemented index low;
- otherwise a 64-bit key, the float's order-preserving 32 bits high and the
  complemented index low.

`canon_zero` first maps -0.0 to +0.0 so the two zeros tie (the packed bf16
route's rule); without it -0.0 ranks below +0.0 (lax.top_k's total order).

Any 1 <= k <= n. The kernel spreads each row over a cluster of CTAs:
a radix select over the keys (8 bits a pass, the cluster's histograms
summed through distributed shared memory, stopping as soon as the k-th
key's bin is taken whole) finds the k-th largest key, the k keys at or
above it are gathered, and they are ordered by rank counting (k <= 2048)
or a bitonic sort (larger k). Details in csrc/topk.cu. Bound: bytes (each
input read once, each output written once). The wrapper is the operator
`leanyolo_tpu_torch::topk` (_build.operator); the key width is chosen
inside its CUDA implementation.

`topk_decode` is the top-k decode's second stage in one launch (the top-k
kernel's body with another key source and epilogue, launched under a name
of its own, `topk_decode_kernel`; csrc/topk.cu says how): the
keys are built from the class rows of stage 1's anchors, gathered as JAX's
one-hot dot gives them (kernels/gather.py, K2), and each of the k winners
is written as its detection row, box decoded from its anchor's reg bins
(kernels/dfl.py, K3), sigmoid score and class. Its plain version is the
composition `gather_rows_plain` -> `topk_plain` -> `dfl_boxes_plain`. The
wrapper is the operator `leanyolo_tpu_torch::topk_decode`; it counts as a
`topk` launch and as a `topk_decode` one.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import LAUNCHES
from . import flags as _flags
from ._build import check_cuda, ext, operator
from .dfl import check_reg, dfl_boxes_plain
from .gather import check_index, check_levels, gather_rows_plain

_PACK32_MAX_N = 32768


def pack_bf16_desc(x: torch.Tensor, canon_zero: bool = True) -> torch.Tensor:
    """bf16 [..., n<=32768] -> s32 keys: descending key order == (value desc, index asc)."""
    if canon_zero:
        x = torch.where(x == 0, torch.zeros_like(x), x)  # -0.0 -> +0.0; every other bit pattern kept
    bits = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    key = torch.where(bits >= 0x8000, 0xFFFF - bits, bits + 0x8000)  # u16, ascending
    idx = torch.arange(x.shape[-1], dtype=torch.int32, device=x.device)
    return (key - 32768) * 65536 + (32767 - idx)


def unpack_bf16_desc(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (packed >> 16) + 32768
    bits = torch.where(key >= 0x8000, key - 0x8000, 0xFFFF - key)
    return bits.to(torch.int16).view(torch.bfloat16), 32767 - (packed & 0xFFFF)


def pack_f32_desc(x: torch.Tensor, canon_zero: bool) -> torch.Tensor:
    """float [..., n] -> s64 keys, the value's order-preserving bits high."""
    x = x.float()
    if canon_zero:
        x = torch.where(x == 0, torch.zeros_like(x), x)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits + 0x80000000)  # u32, ascending
    idx = torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)
    return (key - 0x80000000) * 0x100000000 + (0xFFFFFFFF - idx)


def unpack_f32_desc(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (packed >> 32) + 0x80000000
    bits = torch.where(key >= 0x80000000, key - 0x80000000, 0xFFFFFFFF - key)
    bits = bits - (bits >= 0x80000000).to(torch.int64) * 0x100000000  # u32 -> s32 bit pattern
    idx = 0xFFFFFFFF - (packed & 0xFFFFFFFF)
    return bits.to(torch.int32).view(torch.float32), idx.to(torch.int32)


def _check_k(n: int, k: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"topk: need 1 <= k <= n, got k={k}, n={n}")


def topk_plain(x: torch.Tensor, k: int, *, canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the same keys, a full sort, the first k."""
    n = x.shape[-1]
    _check_k(n, k)
    if x.dtype == torch.bfloat16 and n <= _PACK32_MAX_N:
        top = torch.sort(pack_bf16_desc(x, canon_zero), dim=-1, descending=True).values[..., :k]
        return unpack_bf16_desc(top)
    top = torch.sort(pack_f32_desc(x, canon_zero), dim=-1, descending=True).values[..., :k]
    vals, idx = unpack_f32_desc(top)
    return vals.to(x.dtype), idx


def _topk_cpu(x: torch.Tensor, k: int, canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, idx = topk_plain(x, k, canon_zero=canon_zero)
    return vals.contiguous(), idx.contiguous()


def _topk_fake(x: torch.Tensor, k: int, canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = tuple(x.shape[:-1]) + (k,)
    return x.new_empty(shape), x.new_empty(shape, dtype=torch.int32)


def _topk_cuda(x: torch.Tensor, k: int, canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    check_cuda(x, "topk")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"topk: bf16 or fp32 input, got {x.dtype}")
    n = x.shape[-1]
    _check_k(n, k)
    if x.ndim == 2:
        vals, idx = ext().topk(x, k, bool(canon_zero))
    else:
        vals, idx = ext().topk(x.reshape(-1, n), k, bool(canon_zero))
        vals, idx = vals.reshape(x.shape[:-1] + (k,)), idx.reshape(x.shape[:-1] + (k,))
    if x.numel():
        LAUNCHES["topk"] += 1
    return vals, idx


_TOPK = operator("topk", "(Tensor x, int k, bool canon_zero) -> (Tensor, Tensor)", cpu=_topk_cpu, cuda=_topk_cuda,
                 fake=_topk_fake)


def topk(x: torch.Tensor, k: int, *, canon_zero: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k (values, int32 indices) over the last dim of a bf16/fp32
    tensor, through the operator `leanyolo_tpu_torch::topk`."""
    return _TOPK(x, k, canon_zero)


def topk_decode_plain(cls_levels: Sequence[torch.Tensor], reg_levels: Sequence[torch.Tensor],
                      hw_shapes: Sequence[Tuple[int, int]], strides: Sequence[float], anchor_idx: torch.Tensor,
                      k: int, *, canon_zero: bool, flags: torch.Tensor) -> torch.Tensor:
    """Plain version of `topk_decode` (the same arguments)."""
    b, nc = anchor_idx.shape[0], cls_levels[0].shape[-1]
    sel = gather_rows_plain(cls_levels, anchor_idx, flags)  # [B, k1, nc]
    vals, pair = topk_plain(sel.reshape(b, -1), k, canon_zero=canon_zero)
    return dfl_boxes_plain(reg_levels, hw_shapes, strides, anchor_idx, pair_idx=pair, pair_logits=vals,
                           num_classes=nc, flags=flags)


def _hw(levels: List[torch.Tensor], widths: List[int]) -> List[Tuple[int, int]]:
    if len(widths) != len(levels) or any(w < 1 or x.shape[1] % w for x, w in zip(levels, widths)):
        raise ValueError("topk_decode: a width for each level, dividing its rows")
    return [(x.shape[1] // w, w) for x, w in zip(levels, widths)]


def _decode_cpu(cls_levels: List[torch.Tensor], reg_levels: List[torch.Tensor], widths: List[int],
                strides: List[float], anchor_idx: torch.Tensor, k: int, canon_zero: bool,
                flags: torch.Tensor) -> torch.Tensor:
    _check_k(anchor_idx.shape[1] * cls_levels[0].shape[-1], k)
    return topk_decode_plain(cls_levels, reg_levels, _hw(reg_levels, widths), strides, anchor_idx, k,
                             canon_zero=canon_zero, flags=flags).contiguous()


def _decode_fake(cls_levels: List[torch.Tensor], reg_levels: List[torch.Tensor], widths: List[int],
                 strides: List[float], anchor_idx: torch.Tensor, k: int, canon_zero: bool,
                 flags: torch.Tensor) -> torch.Tensor:
    return anchor_idx.new_empty((anchor_idx.shape[0], k, 6), dtype=torch.float32)


def _decode_cuda(cls_levels: List[torch.Tensor], reg_levels: List[torch.Tensor], widths: List[int],
                 strides: List[float], anchor_idx: torch.Tensor, k: int, canon_zero: bool,
                 flags: torch.Tensor) -> torch.Tensor:
    if not 1 <= len(cls_levels) <= 4 or len(reg_levels) != len(cls_levels) or len(strides) != len(cls_levels):
        raise ValueError("topk_decode: 1 to 4 levels, each with its class and reg maps, a width and a stride")
    _hw(reg_levels, widths)
    check_levels(cls_levels, "topk_decode class maps")
    check_reg(reg_levels, "topk_decode reg maps")
    b, nc = cls_levels[0].shape[0], cls_levels[0].shape[2]
    if reg_levels[0].shape[0] != b or any(r.shape[1] != c.shape[1] for r, c in zip(reg_levels, cls_levels)):
        raise ValueError("topk_decode: the reg maps' batch and rows are the class maps'")
    check_index(anchor_idx, b, "topk_decode anchor_idx")
    _check_k(anchor_idx.shape[1] * nc, k)
    _flags.check(flags, b, nc, "topk_decode flags")
    out = torch.empty(b, k, 6, dtype=torch.float32, device=anchor_idx.device)
    if out.numel():
        ext().topk_decode(cls_levels, reg_levels, widths, strides, anchor_idx, int(k), bool(canon_zero), flags, out)
        LAUNCHES["topk"] += 1
        LAUNCHES["topk_decode"] += 1
    return out


_TOPK_DECODE = operator("topk_decode", "(Tensor[] cls_levels, Tensor[] reg_levels, int[] widths, float[] strides, "
                                       "Tensor anchor_idx, int k, bool canon_zero, Tensor flags) -> Tensor",
                        cpu=_decode_cpu, cuda=_decode_cuda, fake=_decode_fake)


def topk_decode(cls_levels: Sequence[torch.Tensor], reg_levels: Sequence[torch.Tensor],
                hw_shapes: Sequence[Tuple[int, int]], strides: Sequence[float], anchor_idx: torch.Tensor, k: int, *,
                canon_zero: bool, flags: torch.Tensor) -> torch.Tensor:
    """The top k of the (anchor, class) pairs of stage 1's anchors
    anchor_idx int32 [B, k1] (over the levels' concatenated anchors), ranked
    as `topk(gather_rows_plain(cls_levels, anchor_idx, flags).reshape(B,
    -1), k, canon_zero=canon_zero)` ranks them -> fp32 [B, k, 6] detections: the
    winner's anchor's box from the reg maps (`dfl_boxes` with the same
    flags), sigmoid(logit), class. Class maps [B, HW_l, nc] and reg maps
    [B, HW_l, 64] of levels with (h, w) shapes and strides, one dtype (bf16
    or fp32); flags: `argmax.max_argmax_flags`' of these maps. Through
    the operator `leanyolo_tpu_torch::topk_decode`."""
    return _TOPK_DECODE(list(cls_levels), list(reg_levels), [int(w) for _, w in hw_shapes],
                        [float(s) for s in strides], anchor_idx, int(k), bool(canon_zero), flags)
