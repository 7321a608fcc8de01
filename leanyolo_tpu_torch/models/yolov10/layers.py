"""YOLOv10 building blocks as PyTorch modules.

Counterparts of the JAX package's `leanyolo_tpu/models/yolov10/layers.py:156-528`.
Module and parameter names mirror the JAX parameter tree one-to-one
(`cv1`, `m.0.cv2`, `bn.running_var`, ...), so a JAX tree loads by a pure
name table (convert.py). Activations are NCHW tensors, kept in the
`channels_last` memory format on the card so cuDNN runs NHWC convs; the
kernels take the NHWC view of the same memory.

Numerics follow the JAX forward, including its rounding points in bf16:
the conv output is rounded to the activation dtype, then the bias (or the
BN affine) and the SiLU run in that dtype; PSA attention scores are stored
in the activation dtype before an fp32 softmax; the upsample-concat 1x1
conv rounds its two halves separately before the add.

The JAX package's conv-input `optimization_barrier` is a TPU-compiler
workaround and numerically the identity; it has no counterpart here.

In training mode (`module.train()`) BatchNorm normalizes with the batch
statistics and advances its running statistics in the forward, as the JAX
train step does after its update (`merge_bn_stats`): nothing in the forward
reads them, so the order makes no difference. The batch moments and their
backward run through the K8 kernel wrappers (kernels/bnstats.py), the SPPF
max pools' backward through the mpbwd kernel wrapper (kernels/mpbwd.py).

Activation checkpointing (`YOLOv10.forward(remat=True)`, the trainer's
`remat="full"`): the model's nodes run through `segment`, which wraps each in
a non-reentrant `torch.utils.checkpoint`; the backward recomputes a node's
activations from its input. The recomputed forward leaves the BN running statistics alone
(`_checkpoint_contexts`), so they advance once a step, as JAX's do where they are an
output of the checkpointed forward.

Data parallelism (`global_batch_stats`, entered by a Trainer on a mesh): a
training-mode BatchNorm sums its moments over the processes of a group, as
JAX's do over the global batch under its mesh. The recompute of a checkpoint
sums over the same group again (it may run on another thread: the group
rides the recompute's context).

Spatial and tensor parallelism (`split_forward`, entered by a Predictor on a
`space` or `model` mesh, parallel/spatial.py and parallel/tensor.py). With a
`Space` active, maps are bands of rows, and `node(level)` tells the layers
the stride of the map a node reads (a stride-2 conv moves it on): each op
whose window spans rows (the stem, the 3x3 convs, dw7x7, s2dconv, the SPPF
pools, `Attention`) reads its band with a halo from the neighbouring ranks
and crops the rows the band's edges made wrong; 1x1 convs and the
upsample-add are per pixel. With a model group active, a layer sliced by
`tp_shard_params` (`tp_split`) computes its slice of the output channels
(a depthwise one from its slice of the input) and gathers the slices.

Folding (fold.py) routes the serving forward through the other kernel
wrappers: dense 1x1 convs become `MatmulConv` (kernels/matmul.py), the
dense 3x3 32 -> 32 convs `S2DConvBNAct` (kernels/s2dconv.py), RepVGGDW
`FusedRepVGGDW` (kernels/dwconv.py).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ...kernels import bnstats, dwconv, matmul, mpbwd, s2dconv

BN_EPS = 1e-3
BN_MOMENTUM = 0.03

Tensor = torch.Tensor

# .recomputing: inside a checkpoint's recompute; .group: the process group
# BatchNorm sums its batch moments over (None: this process's batch alone);
# .space: the spatial split's Space (None: whole maps); .level: the stride of
# the map the running node reads; .model_group: the `Channels` tensor-parallel
# layers gather their output channels over.
_remat = threading.local()


@contextlib.contextmanager
def _context(**values):
    before = {k: getattr(_remat, k, None) for k in values}
    for k, v in values.items():
        setattr(_remat, k, v)
    try:
        yield
    finally:
        for k, v in before.items():
            setattr(_remat, k, v)


def global_batch_stats(group):
    """Within this context, training-mode BatchNorms take their batch
    statistics over the global batch: the moments of every process of
    `group` (a torch.distributed group; None: this process alone). Every
    process must hold the same number of rows."""
    return _context(group=group)


def split_forward(space=None, model_group=None):
    """Within this context the forward runs split: over a `Space`'s bands
    (parallel/spatial.py; the images are this rank's band) or, with a
    model group (`parallel.tensor.Channels`), with the `tp_split` layers'
    output channels gathered over it."""
    return _context(space=space, level=1, model_group=model_group)


def node(on: bool, level: int, fn, *args, **kwargs):
    """`segment(on, fn, ...)` of a node that reads maps at stride `level`."""
    if getattr(_remat, "space", None) is None:
        return segment(on, fn, *args, **kwargs)
    with _context(level=level):
        return segment(on, fn, *args, **kwargs)


def _split_space():
    """(Space, level) when the map at the current level is split into bands, else (None, level)."""
    sp = getattr(_remat, "space", None)
    level = getattr(_remat, "level", 1)
    return (sp if sp is not None and sp.plan.split(level) else None), level


def _moved(stride: int) -> None:
    """A stride-`stride` op ran: later ops of the node read the next level."""
    if getattr(_remat, "space", None) is not None:
        _remat.level *= stride


def _tp_out(layer: nn.Module, y: Tensor) -> Tensor:
    """A tensor-parallel layer's output-channel slice, gathered over the
    model group into the whole output (the other layers' output as it is)."""
    if layer.tp_split is None:
        return y
    channels = getattr(_remat, "model_group", None)
    if channels is None:
        raise RuntimeError("a layer sliced by tp_shard_params runs outside its model group "
                           "(Predictor(mesh=make_tp_mesh(...)) enters it)")
    return channels.gather(y)


def _checkpoint_contexts():
    # Made in the forward; the recompute (in the backward) reduces over the
    # forward's group and leaves the running statistics alone.
    return contextlib.nullcontext(), _context(recomputing=True, group=getattr(_remat, "group", None))


def segment(on: bool, fn, *args, **kwargs):
    """fn(*args, **kwargs), checkpointed when `on` and autograd records: the
    backward recomputes fn's activations from its inputs (the forward draws
    no random numbers, so no RNG state is kept)."""
    if not (on and torch.is_grad_enabled()):
        return fn(*args, **kwargs)
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=_checkpoint_contexts, **kwargs)


def _uniform(shape, bound: float, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound, generator=generator))


class Conv(nn.Module):
    """Plain 2D conv (`weight` OIHW, optional `bias`), torch-style k//2 padding.

    The bias is added after the conv output is rounded to the activation
    dtype, as the JAX forward does (`conv2d(...) + b.astype(x.dtype)`).
    Init matches torch's Conv2d default (kaiming-uniform, a=sqrt(5)).
    """

    #: (n, index) of a bare conv sliced by tp_shard_params; `channels`: the
    #: input channels a sliced depthwise conv reads.
    tp_split: Optional[Tuple[int, int]] = None
    channels: Optional[slice] = None

    def __init__(self, c_in: int, c_out: int, k: int, *, stride: int = 1, groups: int = 1,
                 padding: Optional[int] = None, bias: bool = False,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.stride, self.groups = stride, groups
        self.padding = k // 2 if padding is None else padding
        fan_in = k * k * (c_in // groups)
        self.weight = _uniform((c_out, c_in // groups, k, k), math.sqrt(3.0 / fan_in), generator)
        if bias:
            self.bias = _uniform((c_out,), 1.0 / math.sqrt(fan_in), generator)
        else:
            self.register_parameter("bias", None)

    def conv(self, x: Tensor, lo: int = 0, hi: Optional[int] = None) -> Tensor:
        """The conv without its bias, over input channels lo:hi of the weight."""
        w = (self.weight if lo == 0 and hi is None else self.weight[:, lo:hi]).to(x.dtype)
        if self.channels is not None:
            x = x[:, self.channels]
        k, s, p = w.shape[2], self.stride, self.padding
        if getattr(_remat, "space", None) is None or (k == 1 and s == 1):
            return F.conv2d(x, w, None, s, p, 1, self.groups)
        sp, level = _split_space()
        _moved(s)
        if sp is not None and s > 1 and not sp.plan.split(level * s):
            x, sp = sp.gather_rows(x, level), None  # the next level runs whole
        if sp is None:
            return F.conv2d(x, w, None, s, p, 1, self.groups)
        # Output rows [a, b) read input rows [s a - p, s (b - 1) - p + k).
        x = sp.halo(x, level, p, k - p - s, 0.0)
        return F.conv2d(x, w, None, s, (0, p), 1, self.groups)

    def forward(self, x: Tensor) -> Tensor:
        y = self.conv(x)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1)
        return _tp_out(self, y)


def _repack(module: nn.Module, incompatible_keys) -> None:
    module.pack()


class MatmulConv(Conv):
    """Folded dense 1x1 stride-1 conv as a matrix product on the NHWC view
    of its input, through the bmm kernel wrapper (kernels/matmul.py), with
    the bias (and, from a folded `ConvBNAct`, the SiLU) in the product's
    epilogue at the JAX forward's rounding points.

    Keeps `weight` (OIHW) and `bias` as `Conv` does; `wt` holds the weight
    as a [Cin, Cout] view of a [Cout, Cin] copy (K-major, the layout the
    wgmma route reads), packed once (and again after a state-dict load),
    out of the state dict. Input channels lo:hi are rows lo:hi of `wt`, a
    view, so each half of an upsample-concat conv runs in place.
    """

    def __init__(self, conv: Conv) -> None:
        nn.Module.__init__(self)
        self.stride, self.groups, self.padding = 1, 1, 0
        self.weight = conv.weight
        self.register_parameter("bias", conv.bias)
        self.register_buffer("wt", None, persistent=False)
        self.pack()
        self.register_load_state_dict_post_hook(_repack)

    def pack(self) -> None:
        with torch.no_grad():
            self.wt = self.weight[:, :, 0, 0].clone(memory_format=torch.contiguous_format).t()

    def conv(self, x: Tensor, lo: int = 0, hi: Optional[int] = None, bias: Optional[Tensor] = None,
             act: bool = False) -> Tensor:
        """The conv over input channels lo:hi, + `bias` and SiLU (`act`) when given."""
        b, c, h, w = x.shape
        y = matmul.bmm(x.permute(0, 2, 3, 1).reshape(b, h * w, c), self.wt[lo:hi], bias, act)
        return y.view(b, h, w, -1).permute(0, 3, 1, 2)

    def forward(self, x: Tensor) -> Tensor:
        return _tp_out(self, self.conv(x, bias=self.bias))


def _sum_over(group, a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """(a, b) summed over the processes of `group`, in one all-reduce."""
    both = torch.cat([a, b])
    dist.all_reduce(both, group=group)
    return both[: a.numel()], both[a.numel():]


class _BatchMoments(torch.autograd.Function):
    """Per-channel (mean, biased var) of y [N, C, H, W] over N, H, W in fp32,
    from one pass of sum and sum of squares: var = max(s2/n - mean^2, 0)
    (JAX `_bn_act`, train branch). The sums come from the K8 kernel wrapper
    (kernels/bnstats.py: one read of y, in a fixed order). With a `group`,
    s1 and s2 are summed over its processes first and n is the global count
    (every process holds the same number of rows), so mean and var are the
    global batch's.

    The backward is the chain rule of that formula, dy = ds1 + 2 y ds2 with
    ds2 = dvar/n and ds1 = (dmean - 2 mean dvar)/n (the [C] coefficients
    here, dy in K8's backward kernel), and keeps only y (which the BN affine
    keeps anyway), where autograd would keep an fp32 copy. With a group, the
    incoming gradients of the moments are summed over it first: each
    process's loss reaches the moments through its own rows.
    """

    @staticmethod
    def forward(ctx, y: Tensor, group):
        n = y.numel() // y.shape[1]
        s1, s2 = bnstats.bn_moments(y)
        if group is not None:
            s1, s2 = _sum_over(group, s1, s2)
            n *= dist.get_world_size(group)
        mean = s1 / n
        raw = s2 / n - mean * mean
        ctx.n, ctx.group = n, group
        ctx.save_for_backward(y, mean, raw > 0)
        return mean, torch.clamp_min(raw, 0.0)

    @staticmethod
    def backward(ctx, g_mean: Tensor, g_var: Tensor):
        y, mean, live = ctx.saved_tensors
        if ctx.group is not None:
            g_mean, g_var = _sum_over(ctx.group, g_mean, g_var)
        g_var = torch.where(live, g_var, 0.0)
        g_s1 = (g_mean - 2.0 * mean * g_var) / ctx.n
        g_s2 = g_var / ctx.n
        return bnstats.bn_moments_bwd(y, g_s1, g_s2), None


class BatchNorm(nn.Module):
    """BatchNorm as an affine epilogue (JAX `_bn_act`).

    mul = rsqrt(var + eps) * scale and add = bias - mean * mul are formed in
    fp32, then cast to the activation dtype before the multiply-add. In
    eval mode mean and var are the running statistics. In training mode
    they are the batch's (`_BatchMoments`, differentiated through), and the
    running statistics advance as (1 - 0.03) old + 0.03 new, with the
    unbiased batch variance var * n / (n - 1) (JAX `merge_bn_stats`), except
    in a checkpoint's recompute, which already advanced them. Within
    `global_batch_stats(group)` the batch statistics, and with them the
    running ones, are the global batch's.
    """

    def __init__(self, c: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def mul_add(self, mean: Optional[Tensor] = None, var: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        mean = self.running_mean.float() if mean is None else mean
        var = self.running_var.float() if var is None else var
        mul = torch.rsqrt(var + BN_EPS) * self.weight.float()
        return mul, self.bias.float() - mean * mul

    def forward(self, y: Tensor) -> Tensor:
        if self.training:
            group = getattr(_remat, "group", None)
            mean, var = _BatchMoments.apply(y, group)
            n = y.numel() // y.shape[1] * (1 if group is None else dist.get_world_size(group))
            if not getattr(_remat, "recomputing", False):
                self._advance(mean, var, n)
            mul, add = self.mul_add(mean, var)
        else:
            mul, add = self.mul_add()
        return y * mul.to(y.dtype).view(1, -1, 1, 1) + add.to(y.dtype).view(1, -1, 1, 1)

    @torch.no_grad()
    def _advance(self, mean: Tensor, var: Tensor, n: int) -> None:
        unbiased = var * (n / max(n - 1, 1))
        self.running_mean.copy_((1.0 - BN_MOMENTUM) * self.running_mean + BN_MOMENTUM * mean)
        self.running_var.copy_((1.0 - BN_MOMENTUM) * self.running_var + BN_MOMENTUM * unbiased)


class ConvBNAct(nn.Module):
    """Conv -> BN -> SiLU (JAX `cba_apply`), unfolded or folded.

    Unfolded: `conv` has no bias and `bn` holds the statistics. Folded
    (fold.py): `conv` carries the bias and `bn` is None.
    """

    #: (n, index) when tp_shard_params sliced its output channels.
    tp_split: Optional[Tuple[int, int]] = None

    def __init__(self, c_in: int, c_out: int, k: int, *, stride: int = 1, groups: int = 1,
                 padding: Optional[int] = None, act: bool = True,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.conv = Conv(c_in, c_out, k, stride=stride, groups=groups, padding=padding, generator=generator)
        self.bn: Optional[BatchNorm] = BatchNorm(c_out)
        self.act = act

    @property
    def folded(self) -> bool:
        return self.bn is None

    def epilogue(self, y: Tensor) -> Tensor:
        """BN (or bias) + SiLU on a conv output already in the activation dtype."""
        if self.bn is not None:
            y = self.bn(y)
        elif self.conv.bias is not None:
            y = y + self.conv.bias.to(y.dtype).view(1, -1, 1, 1)
        return F.silu(y) if self.act else y

    def forward(self, x: Tensor) -> Tensor:
        if self.bn is None and isinstance(self.conv, MatmulConv):
            y = self.conv.conv(x, bias=self.conv.bias, act=self.act)  # bias and SiLU in the bmm epilogue
        else:
            y = self.epilogue(self.conv.conv(x))
        return _tp_out(self, y)

    def forward_upcat(self, a: Tensor, b: Tensor) -> Tensor:
        """`forward(cat([upsample2x(a), b]))` for a 1x1 conv, with the conv
        distributed over the concat (JAX `cba_apply_upcat`): each half is
        convolved and rounded on its own, then the upsampled a-half is added.
        """
        w = self.conv.weight
        assert w.shape[2] == 1 and w.shape[3] == 1, "upcat distribution needs a 1x1 conv"
        ca = a.shape[1]
        ya = F.interpolate(self.conv.conv(a, 0, ca), scale_factor=2, mode="nearest")
        yb = self.conv.conv(b, ca)
        sp, level = _split_space()
        if sp is not None and not sp.plan.split(2 * level):
            ya = sp.take_band(ya, level)  # a whole map feeds a split level
        return _tp_out(self, self.epilogue(ya + yb))


def _cat(xs: Sequence[Tensor]) -> Tensor:
    return torch.cat(list(xs), dim=1)


class Bottleneck(nn.Module):
    """3x3 -> 3x3 with residual."""

    def __init__(self, c_in: int, c_out: int, *, shortcut: bool, e: float = 1.0, generator=None) -> None:
        super().__init__()
        c_hidden = int(c_out * e)
        self.cv1 = ConvBNAct(c_in, c_hidden, 3, generator=generator)
        self.cv2 = ConvBNAct(c_hidden, c_out, 3, generator=generator)
        self.add = shortcut and c_in == c_out

    def forward(self, x: Tensor) -> Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


UpcatInput = Union[Tensor, Tuple[Tensor, Tensor]]


def _cv1_maybe_upcat(cv1: ConvBNAct, x: UpcatInput) -> Tensor:
    """`x` may be an `(a, b)` tuple meaning `cat([upsample2x(a), b])`."""
    if isinstance(x, tuple):
        return cv1.forward_upcat(*x)
    return cv1(x)


class C2f(nn.Module):
    """Split-transform-merge C2f; with `lk` a bool, the C2fCIB scaffold
    (CIB inner blocks with that long-kernel flag)."""

    def __init__(self, c_in: int, c_out: int, n: int, *, shortcut: bool, e: float = 0.5,
                 lk: Optional[bool] = None, generator=None) -> None:
        super().__init__()
        c = int(c_out * e)
        self.c = c
        g = generator
        self.cv1 = ConvBNAct(c_in, 2 * c, 1, generator=g)
        self.cv2 = ConvBNAct((2 + n) * c, c_out, 1, generator=g)
        if lk is None:
            self.m = nn.ModuleList(Bottleneck(c, c, shortcut=shortcut, generator=g) for _ in range(n))
        else:
            self.m = nn.ModuleList(CIB(c, c, shortcut=shortcut, lk=lk, generator=g) for _ in range(n))

    def forward(self, x: UpcatInput) -> Tensor:
        y = _cv1_maybe_upcat(self.cv1, x)
        ys = [y[:, : self.c], y[:, self.c :]]
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(_cat(ys))


class SPPF(nn.Module):
    """1x1 -> 3 chained 5x5 max pools -> concat -> 1x1."""

    def __init__(self, c_in: int, c_out: int, k: int = 5, generator=None) -> None:
        super().__init__()
        c_hidden = c_in // 2
        self.k = k
        self.cv1 = ConvBNAct(c_in, c_hidden, 1, generator=generator)
        self.cv2 = ConvBNAct(c_hidden * 4, c_out, 1, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        x = self.cv1(x)
        ys = [x]
        for _ in range(3):
            ys.append(maxpool2d_same(ys[-1], self.k))
        return self.cv2(_cat(ys))


class _MaxPoolSame(torch.autograd.Function):
    """k x k max pool, stride 1, same padding; the backward is the mpbwd
    kernel wrapper on the NHWC view (no copy for a channels_last tensor)."""

    @staticmethod
    def forward(ctx, x: Tensor, k: int) -> Tensor:
        ctx.k = k
        ctx.save_for_backward(x)
        return F.max_pool2d(x, k, stride=1, padding=k // 2)

    @staticmethod
    def backward(ctx, dy: Tensor):
        (x,) = ctx.saved_tensors
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()
        return mpbwd.mpbwd(nhwc(x), nhwc(dy), ctx.k).permute(0, 3, 1, 2), None


def maxpool2d_same(x: Tensor, k: int) -> Tensor:
    """k x k max pool, stride 1, same padding (the pad never wins: -inf).

    The forward is `F.max_pool2d`, as JAX's is `reduce_window` outside
    Pallas; the backward routes each window's gradient to the first
    (row-major) position holding its max, as XLA's select-and-scatter and
    the Pallas kernel do. On a band, the rows beyond the image are -inf as
    well: SPPF's input follows a SiLU and can be negative.
    """
    sp, level = _split_space()
    if sp is not None:
        return F.max_pool2d(sp.halo(x, level, k // 2, k // 2, float("-inf")), k, stride=1, padding=(0, k // 2))
    return _MaxPoolSame.apply(x, k)


class RepVGGDW(nn.Module):
    """Depthwise 7x7 + 3x3 dual branch, SiLU on the sum (unfolded form).

    fold.py replaces it with `FusedRepVGGDW`, one 7x7 depthwise conv.
    """

    def __init__(self, ch: int, generator=None) -> None:
        super().__init__()
        self.conv = ConvBNAct(ch, ch, 7, groups=ch, padding=3, act=False, generator=generator)
        self.conv1 = ConvBNAct(ch, ch, 3, groups=ch, padding=1, act=False, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        return F.silu(self.conv(x) + self.conv1(x))


class FusedRepVGGDW(ConvBNAct):
    """Folded RepVGGDW: depthwise 7x7 (pad 3) + bias + SiLU.

    Runs through the dw7x7 kernel wrapper (kernels/dwconv.py): the
    hand-written CUDA kernel for a tensor on the card, its plain PyTorch
    version for a tensor on the CPU. `w49` holds the weight as [49, C]
    (`dwconv.pack_weights`), packed once (and again after a state-dict
    load), out of the state dict.
    """

    def __init__(self, ch: int, weight: Tensor, bias: Tensor) -> None:
        super().__init__(ch, ch, 7, groups=ch, padding=3, act=True, generator=torch.Generator())
        self.bn = None
        self.conv.weight = nn.Parameter(weight)
        self.conv.bias = nn.Parameter(bias)
        self.register_buffer("w49", None, persistent=False)
        self.pack()
        self.register_load_state_dict_post_hook(_repack)

    def pack(self) -> None:
        with torch.no_grad():
            self.w49 = dwconv.pack_weights(self.conv.weight)

    def forward(self, x: Tensor) -> Tensor:
        if self.conv.channels is not None:
            x = x[:, self.conv.channels]
        sp, level = _split_space()
        if sp is not None:
            x = sp.halo(x, level, 3, 3, 0.0)
        y = dwconv.dw7x7_bias_silu(x.permute(0, 2, 3, 1).contiguous(), self.w49, self.conv.bias)
        if sp is not None:
            y = y[:, 3:-3]
        return _tp_out(self, y.permute(0, 3, 1, 2))


class S2DConvBNAct(ConvBNAct):
    """Folded dense 3x3 stride-1 conv, 32 -> 32 channels, + bias + SiLU, as
    the 2x2 conv over the space-to-depth form, through the s2dconv kernel
    wrapper (kernels/s2dconv.py).

    Keeps the folded `conv` (OIHW weight, bias); `w_s2d` holds the weight
    packed once by `w_s2d_k3` (and again after a state-dict load), out of
    the state dict.
    """

    def __init__(self, conv: Conv) -> None:
        nn.Module.__init__(self)
        self.conv, self.bn, self.act = conv, None, True
        self.register_buffer("w_s2d", None, persistent=False)
        self.pack()
        self.register_load_state_dict_post_hook(_repack)

    def pack(self) -> None:
        with torch.no_grad():
            self.w_s2d = s2dconv.pack_weights(self.conv.weight)

    def forward(self, x: Tensor) -> Tensor:
        sp, level = _split_space()
        if sp is not None:
            x = sp.halo(x, level, 2, 2, 0.0)  # whole row pairs: the band's S2D cells stay the image's
        y = s2dconv.conv3x3_c32_bias_silu(x.permute(0, 2, 3, 1), self.w_s2d, self.conv.bias)
        if sp is not None:
            y = y[:, 2:-2]
        return y.permute(0, 3, 1, 2)


class CIB(nn.Module):
    """Compact inverted block."""

    def __init__(self, c_in: int, c_out: int, *, shortcut: bool, e: float = 1.0, lk: bool = False,
                 generator=None) -> None:
        super().__init__()
        mid = 2 * int(c_out * e)
        g = generator
        self.cv1 = nn.ModuleList([
            ConvBNAct(c_in, c_in, 3, groups=c_in, generator=g),
            ConvBNAct(c_in, mid, 1, generator=g),
            RepVGGDW(mid, generator=g) if lk else ConvBNAct(mid, mid, 3, groups=mid, generator=g),
            ConvBNAct(mid, c_out, 1, generator=g),
            ConvBNAct(c_out, c_out, 3, groups=c_out, generator=g),
        ])
        self.add = shortcut and c_in == c_out

    def forward(self, x: Tensor) -> Tensor:
        y = x
        for m in self.cv1:
            y = m(y)
        return x + y if self.add else y


class Attention(nn.Module):
    """Multi-head self-attention over spatial tokens + depthwise positional branch."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5, generator=None) -> None:
        super().__init__()
        self.nh = max(1, num_heads)
        self.hd = dim // self.nh
        self.kd = int(self.hd * attn_ratio)
        self.scale = self.kd ** -0.5
        h = dim + self.kd * self.nh * 2
        self.qkv = ConvBNAct(dim, h, 1, act=False, generator=generator)
        self.proj = ConvBNAct(dim, dim, 1, act=False, generator=generator)
        self.pe = ConvBNAct(dim, dim, 3, groups=dim, act=False, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        b, c, h, w = x.shape
        n, nh, kd, hd = h * w, self.nh, self.kd, self.hd
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, n, nh, 2 * kd + hd)
        q, k, v = qkv[..., :kd], qkv[..., kd : 2 * kd], qkv[..., 2 * kd :]
        kk, vv = k, v
        sp, level = _split_space()
        if sp is not None:  # this band's queries against every row's keys and values
            kv = sp.gather_rows(qkv[..., kd:].reshape(b, h, w, nh * (kd + hd)), level, dim=1)
            kv = kv.reshape(b, -1, nh, kd + hd)
            kk, vv = kv[..., :kd], kv[..., kd:]
        # Scores accumulate in fp32 and are stored in the activation dtype;
        # the softmax runs in fp32 (JAX layers.py:469-477).
        attn = (torch.einsum("bine,bjne->bnij", q.float(), kk.float()) * self.scale).to(x.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.einsum("bnij,bjnd->bind", attn.float(), vv.float()).to(v.dtype)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        pe = self.pe(v.reshape(b, h, w, c).permute(0, 3, 1, 2))
        return self.proj(out + pe)


class PSA(nn.Module):
    """Partial self-attention."""

    def __init__(self, c_in: int, e: float = 0.5, generator=None) -> None:
        super().__init__()
        c = int(c_in * e)
        self.c = c
        g = generator
        self.cv1 = ConvBNAct(c_in, 2 * c, 1, generator=g)
        self.cv2 = ConvBNAct(2 * c, c_in, 1, generator=g)
        self.attn = Attention(c, max(1, c // 64), 0.5, generator=g)
        self.ffn = nn.ModuleList([ConvBNAct(c, c * 2, 1, generator=g), ConvBNAct(c * 2, c, 1, act=False, generator=g)])

    def forward(self, x: Tensor) -> Tensor:
        y = self.cv1(x)
        a, b = y[:, : self.c], y[:, self.c :]
        b = b + self.attn(b)
        b = b + self.ffn[1](self.ffn[0](b))
        return self.cv2(_cat((a, b)))


class SCDown(nn.Module):
    """Spatial-channel decoupled downsample; no activation on the DW conv."""

    def __init__(self, c_in: int, c_out: int, generator=None) -> None:
        super().__init__()
        self.cv1 = ConvBNAct(c_in, c_out, 1, generator=generator)
        self.cv2 = ConvBNAct(c_out, c_out, 3, stride=2, groups=c_out, act=False, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        return self.cv2(self.cv1(x))
