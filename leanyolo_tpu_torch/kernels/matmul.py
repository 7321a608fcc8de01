"""Matrix product [B, M, K] x [K, N] with an fp32 sum and the folded conv's
epilogue: CUDA kernels (csrc/matmul.cu) and plain version.

Every dense 1x1 stride-1 conv of the folded model runs through it on the
NHWC view of its input (M = H*W). Replaces the JAX package's Pallas kernel
`experiments/exp_pallas_mm.py:40 pallas_mm`, for any B, M, K and N. The
products are summed in fp32 and rounded to the input's dtype, where the
folded JAX forward rounds a conv's output; then, as that forward does
(`leanyolo_tpu/models/yolov10/layers.py:214-217`), the bias is added and
rounded and SiLU applied and rounded, each optional.

Two hand-written kernels, chosen by shape (`route`): TMA + wgmma for bf16
that TMA can describe (every call of the serving path), ldmatrix +
mma.sync for fp32 and the other bf16 shapes. A failed launch raises; no
route stands in for the other. The wrapper is the operator
`leanyolo_tpu_torch::bmm` (_build.operator); the route is chosen inside its
CUDA implementation, so a traced batch stays symbolic.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import LAUNCHES
from ._build import check_cuda, ext, operator

H100_SMS = 132  # the plan's default where no card is asked


def bmm_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
              act: bool = False) -> torch.Tensor:
    """x [B, M, K], w [K, N], bias [N] -> [B, M, N] in x's dtype: fp32 sum
    rounded, + bias rounded, SiLU rounded."""
    y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return F.silu(y) if act else y


def _row_stride(x: torch.Tensor):
    """The stride between the B*M rows of x [B, M, K] when they are evenly
    spaced with unit stride in K (a channel slice of an NHWC map), else None."""
    b, m, k = x.shape
    if x.stride(2) != 1:
        return None
    lda = x.stride(1) if m > 1 else x.stride(0)
    if b > 1 and m > 1 and x.stride(0) != m * lda:
        return None
    return lda if lda >= k else None


def wgmma_plan(rows: int, n: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(tile width, consumer pairs) of the wgmma route for rows x N outputs.

    Tiles are 128 rows by 64 (N <= 64), 80 (N <= 80: the head's cls conv;
    its 64-wide store boxes would cross into a next tile otherwise) or 128
    columns. Two consumer pairs, which overlap one tile's epilogue with the
    next tile's products, where each CTA (one per SM) gets at least two
    tiles; else one pair with the whole ring of stages (the 20x20 maps with
    K up to 1024, where the ring's depth matters more).
    """
    tile_n = 64 if n <= 64 else 80 if n <= 80 else 128
    tiles = -(-rows // 128) * -(-n // tile_n)
    return tile_n, 2 if tiles >= 2 * sms else 1


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def route(x: torch.Tensor, lda: int, n: int) -> Tuple[str, Optional[Tuple[int, int]]]:
    """("wgmma", wgmma_plan) for bf16 x whose rows TMA can describe (K, N
    and lda multiples of 8, a 16-byte aligned base), else ("mma.sync", None)."""
    b, m, k = x.shape
    if (x.dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 and lda % 8 == 0
            and x.data_ptr() % 16 == 0):
        sms = _sm_count(x.device.index) if x.is_cuda else H100_SMS
        return "wgmma", wgmma_plan(b * m, n, sms)
    return "mma.sync", None


def _k_major(w: torch.Tensor) -> torch.Tensor:
    """w [K, N] with unit stride in K and 16-byte aligned rows of K (a view
    of a [N, K] weight, as MatmulConv packs it, is taken as it is)."""
    if w.stride(0) == 1 and w.stride(1) >= w.shape[0] and w.stride(1) % 8 == 0 and w.data_ptr() % 16 == 0:
        return w
    return w.t().contiguous().t()


def _bmm_cpu(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], act: bool) -> torch.Tensor:
    return bmm_plain(x, w, bias, act).contiguous()


def _bmm_fake(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], act: bool) -> torch.Tensor:
    return x.new_empty((x.shape[0], x.shape[1], w.shape[1]))


def _bmm_cuda(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], act: bool) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float32) or x.ndim != 3 or w.ndim != 2 or w.shape[0] != x.shape[2]:
        raise ValueError(f"bmm: bf16 or fp32 x [B, M, K] and w [K, N], got {x.dtype} {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"bmm: expected a CUDA tensor, got one on {x.device}")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"bmm: bias [{w.shape[1]}], got {tuple(bias.shape)}")
    lda = _row_stride(x)
    if lda is None:
        x = x.contiguous()
        lda = x.shape[2]
    bk = None
    if bias is not None:
        bk = bias.to(x.dtype).contiguous()
        check_cuda(bk, "bmm bias")
    elif act:  # the kernels apply SiLU after a bias; adding zeros is exact
        bk = torch.zeros(w.shape[1], dtype=x.dtype, device=x.device)
    b, m, _ = x.shape
    n = w.shape[1]
    out = torch.empty(b, m, n, dtype=x.dtype, device=x.device)
    if out.numel():
        which, plan = route(x, lda, n)
        if which == "wgmma":
            wk = _k_major(w.to(x.dtype))
            if wk.device.type != "cuda":
                raise ValueError(f"bmm w: expected a CUDA tensor, got one on {wk.device}")
            ext().bmm_wgmma(x, wk, out, bk, b * m, lda, act, *plan)
            LAUNCHES["bmm_wgmma"] += 1
        else:
            wk = w.to(x.dtype).contiguous()
            check_cuda(wk, "bmm w")
            ext().bmm(x, wk, out, bk, b * m, lda, act)
        LAUNCHES["bmm"] += 1
    return out


_BMM = operator("bmm", "(Tensor x, Tensor w, Tensor? bias, bool act) -> Tensor", cpu=_bmm_cpu, cuda=_bmm_cuda,
                fake=_bmm_fake)


def bmm(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, act: bool = False) -> torch.Tensor:
    """x [B, M, K] (rows read in place where evenly strided), w [K, N], bias
    [N] or None, act: SiLU -> [B, M, N] contiguous, in x's dtype, through
    the operator `leanyolo_tpu_torch::bmm`."""
    return _BMM(x, w, bias, act)
