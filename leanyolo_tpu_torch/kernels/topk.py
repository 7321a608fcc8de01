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
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import LAUNCHES
from ._build import check_cuda, ext, operator

_PACK32_MAX_N = 32768


def pack_bf16_desc(x: torch.Tensor, canon_zero: bool = True) -> torch.Tensor:
    """bf16 [..., n<=32768] -> s32 keys: descending key order == (value desc, index asc)."""
    if canon_zero:
        x = x + 0.0  # -0.0 -> +0.0; the identity elsewhere
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
        x = x + 0.0
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
