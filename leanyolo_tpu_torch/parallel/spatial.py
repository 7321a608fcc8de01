"""Spatial parallelism: the rows of each image split over a mesh's `space` axis.

Counterpart of what XLA's GSPMD does for the JAX package's `make_sp_mesh`
(`leanyolo_tpu/parallel/mesh.py:85-98`), which shards H and inserts the halo
exchanges itself. Here each process of a space group holds a band of rows of
every map it can split and exchanges the rows its windows reach across a
band edge with its neighbours:

- `plan_bands(height, n)`: the bands, computed once per (image size, n).
  The deepest level whose rows number at least n is cut into n bands as
  evenly as rows allow; every shallower level (stride 1, 2, 4, ...) takes
  the same cuts scaled up, so its bands start on rows that a stride-2 conv
  (and an s2dconv, in whole row pairs) can start on. The deeper levels run
  whole on every rank: a stride-2 conv into such a level gathers its input
  over `space` first, and a whole map that feeds a split level (the neck's
  upsamples) is cut to the band locally, with no communication. At 64 px
  over 4 ranks only strides 1-16 split; at 640 px over 2 or 4 every level
  does (`plan_bands(640, n).describe()` prints a plan).
- `Space.halo(x, level, above, below, fill)`: the band with `above` rows of
  the rank above and `below` rows of the rank below, `fill` beyond the
  image's true edges (None: no rows there). Each rank contributes the rows
  its neighbours need to one all-gather over the group (a band shorter than
  the halo gathers the whole level instead). Callers crop the output rows
  that the band's edges made wrong.
- `Space.gather_rows` / `take_band`: a whole level from the bands (padded
  to the tallest band, all-gathered, trimmed) and a band of a whole level.

The model reads the active `Space` and the current level from the layers'
thread-local context (`layers.split_forward`, `layers.node`). Tensors cross
the group as contiguous copies, bf16 as its bytes, so that gloo (the
CPU, or ranks sharing one card, through host copies) and NCCL both carry
them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

STRIDES = (1, 2, 4, 8, 16, 32)


@dataclass(frozen=True)
class BandPlan:
    """Row bands of an image of `height` rows over `n` ranks. `deepest`:
    the deepest split stride (0: nothing splits); `cuts`: the n + 1 band
    edges at that level."""

    height: int
    n: int
    deepest: int
    cuts: Tuple[int, ...]

    def split(self, stride: int) -> bool:
        return 0 < stride <= self.deepest

    def band(self, stride: int, pos: int) -> Tuple[int, int]:
        """Rows [lo, hi) of the level at `stride` that rank `pos` holds
        (the whole level where it does not split)."""
        if not self.split(stride):
            return 0, self.height // stride
        f = self.deepest // stride
        return self.cuts[pos] * f, self.cuts[pos + 1] * f

    def heights(self, stride: int) -> List[int]:
        return [hi - lo for lo, hi in (self.band(stride, p) for p in range(self.n))]

    def describe(self) -> str:
        levels = []
        for s in STRIDES:
            if self.split(s):
                levels.append(f"/{s}: " + " ".join(f"{lo}-{hi}" for lo, hi in
                                                   (self.band(s, p) for p in range(self.n))))
            else:
                levels.append(f"/{s}: whole {self.height // s}")
        return f"{self.height} px over {self.n}: " + "; ".join(levels)


@functools.lru_cache(maxsize=None)
def plan_bands(height: int, n: int) -> BandPlan:
    """The band plan of `height` rows over `n` ranks (module doc)."""
    if n < 1:
        raise ValueError(f"a space group of {n} ranks")
    deepest = next((s for s in STRIDES[:1:-1] if height % s == 0 and height // s >= n), 0) if n > 1 else 0
    if not deepest:
        return BandPlan(height, n, 0, ())
    rows = height // deepest
    q, r = divmod(rows, n)
    cuts = [0]
    for p in range(n):
        cuts.append(cuts[-1] + q + (p < r))
    return BandPlan(height, n, deepest, tuple(cuts))


def _wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def _unwire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.view(dtype) if dtype == torch.bfloat16 else t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """t from every rank of `group`, in rank order (t of one shape on every
    rank). Under gloo a card's tensor crosses as a host copy."""
    w = _wire(t)
    staged = w.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        w = w.cpu()
    got = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, w, group=group)
    return [_unwire(g.to(t.device) if staged else g, t.dtype) for g in got]


def _keep_format(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """y in channels_last memory where `like` (NCHW) was."""
    if like.ndim == 4 and not like.is_contiguous() and like.is_contiguous(memory_format=torch.channels_last):
        return y.contiguous(memory_format=torch.channels_last)
    return y


class Space:
    """This rank's place in a space group: the plan, the group and its
    position. `exchange(t)`, when given, stands in for the all-gather (tests
    run the ranks as threads of one process). `traffic` counts the bytes
    this rank received, by kind."""

    def __init__(self, plan: BandPlan, group, pos: int, exchange=None) -> None:
        self.plan, self.group, self.pos, self.exchange = plan, group, int(pos), exchange
        self.traffic = {"halo": 0, "rows": 0}

    def all_gather(self, t: torch.Tensor, kind: str) -> List[torch.Tensor]:
        """t from every rank of the group, in rank order (t of equal shape)."""
        parts = self.exchange(t.contiguous()) if self.exchange is not None else all_gather(t, self.group)
        self.traffic[kind] += (self.plan.n - 1) * t.numel() * t.element_size()
        return parts

    def gather_rows(self, x: torch.Tensor, level: int, dim: int = 2, kind: str = "rows") -> torch.Tensor:
        """The whole level at `level` from every rank's band of it (rank order)."""
        heights = self.plan.heights(level)
        pad = max(heights) - x.shape[dim]
        x_pad = torch.cat([x, _rows(x, dim, pad, 0)], dim) if pad else x
        parts = self.all_gather(x_pad, kind)
        return _keep_format(torch.cat([p.narrow(dim, 0, h) for p, h in zip(parts, heights)], dim), x)

    def take_band(self, x: torch.Tensor, level: int, dim: int = 2) -> torch.Tensor:
        lo, hi = self.plan.band(level, self.pos)
        return x.narrow(dim, lo, hi - lo)

    def halo(self, x: torch.Tensor, level: int, above: int, below: int, fill: Optional[float],
             dim: int = 2) -> torch.Tensor:
        """This rank's band of the level at `level` with `above` rows before
        it and `below` after it: the neighbours' rows, and `fill` beyond the
        image's edges (None: no rows there, so a band at the top gets
        min(above, lo) rows above)."""
        lo, hi = self.plan.band(level, self.pos)
        h, full = hi - lo, self.plan.height // level
        if x.shape[dim] != h:
            raise ValueError(f"halo: a band of {x.shape[dim]} rows at stride {level}, the plan gives {h}")
        if min(self.plan.heights(level)) >= max(above, below):
            # Each rank sends its first `below` rows (the halo of the rank
            # above) and its last `above` rows (that of the rank below).
            parts = self.all_gather(torch.cat([x.narrow(dim, 0, below), x.narrow(dim, h - above, above)], dim),
                                    "halo")
            up = parts[self.pos - 1].narrow(dim, below, above) if lo > 0 else None
            down = parts[self.pos + 1].narrow(dim, 0, below) if hi < full else None
        else:  # a band shorter than the halo: the whole level
            whole = self.gather_rows(x, level, dim, kind="halo")
            top = max(lo - above, 0)
            up, down = whole.narrow(dim, top, lo - top), whole.narrow(dim, hi, min(hi + below, full) - hi)
        pieces = []
        if above:
            got = 0 if up is None else up.shape[dim]
            if fill is not None and got < above:
                pieces.append(_rows(x, dim, above - got, fill))
            if got:
                pieces.append(up)
        pieces.append(x)
        if below:
            got = 0 if down is None else down.shape[dim]
            if got:
                pieces.append(down)
            if fill is not None and got < below:
                pieces.append(_rows(x, dim, below - got, fill))
        return x if len(pieces) == 1 else _keep_format(torch.cat(pieces, dim), x)


def _rows(x: torch.Tensor, dim: int, n: int, fill: float) -> torch.Tensor:
    """n rows of `fill` shaped as x's rows along dim."""
    shape = list(x.shape)
    shape[dim] = n
    return x.new_full(shape, fill)

