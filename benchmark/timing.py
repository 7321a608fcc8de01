"""Timers and the reading of a device trace.

Frozen copies of the system's own arithmetic (its profiling utilities):
the kernel family of a demangled or mangled name (`family`) and the busy
time as the union of intervals (`union_s`). The windows time themselves
(serve.py: events mapped onto the host's clock; train.py: whole steps).

`Profile` runs `torch.profiler` over a stretch of steady state, with idle
pads on both sides (the profiler keeps only the device records whose
timestamps fall inside its window), and turns its events into plain
records: each kernel with its family, duration and the host time of its
launch (found through the profiler's correlation ids), the device's
copies and fills, and the harness's own spans (`torch.profiler.
record_function`). A trace whose device holds no kernel record raises:
a device time never reads 0 because its records are missing.
"""

from __future__ import annotations

import re
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

PAD_S = 0.25


def _mangled_base(name: str) -> Optional[str]:
    """The last identifier of an Itanium-mangled name's (nested) name."""
    s = name[2:]
    if s.startswith("N"):
        s = s[1:].lstrip("rVKRO")
        s = s[2:] if s.startswith("St") else s
    ids = []
    while s[:1].isdigit():
        n = re.match(r"\d+", s).group()
        s = s[len(n):]
        ids.append(s[:int(n)])
        s = s[int(n):]
    return ids[-1] if ids else None


def family(name: str) -> str:
    """The base identifier of a kernel's demangled C++ name, without return
    type, namespaces, template arguments or parameter list
    (`void (anonymous namespace)::gemm_kernel<128, 2>(...)` -> `gemm_kernel`);
    a mangled name's last identifier; a name that is not C++ is its own
    family."""
    mangled = _mangled_base(name) if name.startswith("_Z") else None
    if mangled:
        return mangled
    s = name.replace("(anonymous namespace)::", "").strip()
    head, depth = [], 0
    for ch in s:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
        elif ch in ">)" and depth:
            depth -= 1
        elif depth == 0:
            head.append(ch)
    base = "".join(head).split()
    if not base:
        return s[:24]
    return base[-1].split("::")[-1] or s[:24]


def union_s(spans: List[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) spans in nanoseconds."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e9


@dataclass
class Kernel:
    family: str
    start: int  # device ns, the profiler's clock
    end: int
    launch: Optional[int]  # host ns of its launch call, the profiler's clock


@dataclass
class Trace:
    """A profiled stretch: kernels, other device work (copies, fills) and
    the harness's spans, all in the profiler's nanoseconds."""

    kernels: List[Kernel]
    other: List[Tuple[int, int]]
    spans: Dict[str, List[Tuple[int, int]]]
    window: Tuple[int, int]  # the stretch, from its first span's start to the device's finish
    units: int = 0  # requests or steps in the stretch
    extra: dict = field(default_factory=dict)

    def busy_s(self) -> float:
        """Seconds in the window in which the device ran a kernel, a copy or a fill."""
        lo, hi = self.window
        return union_s([(max(a, lo), min(b, hi)) for a, b in
                        [(k.start, k.end) for k in self.kernels] + self.other if b > lo and a < hi])

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def span_kernel_s(self, name: str) -> Optional[float]:
        """Summed device seconds of the kernels launched inside span `name`
        (None when the span never ran)."""
        spans = sorted(self.spans.get(name, []))
        if not spans:
            return None
        import bisect

        starts = [a for a, _ in spans]
        total = 0.0
        for k in self.kernels:
            if k.launch is None:
                continue
            i = bisect.bisect_right(starts, k.launch) - 1
            if i >= 0 and k.launch <= spans[i][1]:
                total += (k.end - k.start) / 1e9
        return total

    def family_s(self, families) -> Tuple[float, int]:
        """(summed device seconds, launches) of the kernels of `families`."""
        ks = [k for k in self.kernels if k.family in families]
        return sum((k.end - k.start) / 1e9 for k in ks), len(ks)

    def top_families(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for k in self.kernels:
            by[k.family] = by.get(k.family, 0.0) + (k.end - k.start) / 1e9
        return [[f, s] for f, s in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds of the device in the window, summed by the harness
        span the host was in when each gap began ('between spans' outside
        every span), the largest first."""
        lo, hi = self.window
        iv = sorted((max(a, lo), min(b, hi)) for a, b in [(k.start, k.end) for k in self.kernels] + self.other
                    if b > lo and a < hi)
        gaps, end = [], lo
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        import bisect

        order = {name: sorted(ss) for name, ss in self.spans.items()}
        starts = {name: [a for a, _ in ss] for name, ss in order.items()}
        by: Dict[str, float] = {}
        for g0, g1 in gaps:
            inner = []  # (length, name) of each span holding the gap's start
            for name, ss in order.items():
                i = bisect.bisect_right(starts[name], g0) - 1
                if i >= 0 and g0 < ss[i][1]:
                    inner.append((ss[i][1] - ss[i][0], name))
            label = min(inner)[1] if inner else "between spans"
            by[label] = by.get(label, 0.0) + (g1 - g0) / 1e9
        return [[f"host in {k}" if k != "between spans" else k, v]
                for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _ns(e, start: bool) -> int:
    if start:
        return int(e.start_ns()) if hasattr(e, "start_ns") else int(e.start_us() * 1000)
    return int(e.end_ns()) if hasattr(e, "end_ns") else int((e.start_us() + e.duration_us()) * 1000)


class Profile:
    """`with Profile(span_names) as p: ...` profiles the body (host and card);
    `p.trace(units)` reads it. The body should end with the device idle."""

    def __init__(self, span_names) -> None:
        self.span_names = set(span_names)
        self._prof = None
        self._t0 = None

    def __enter__(self) -> "Profile":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(PAD_S)
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        self._prof.__exit__(*exc)

    def trace(self, units: int) -> Trace:
        events = self._prof.profiler.kineto_results.events()
        kernels_raw, other, spans, launches, launch_calls = [], [], {}, {}, set()
        for e in events:
            name = e.name()
            on_device = "cuda" in str(e.device_type()).lower()
            if on_device:
                if name in self.span_names:
                    continue  # the device's copy of a host span
                if name.startswith("Memcpy") or name.startswith("Memset"):
                    other.append((_ns(e, True), _ns(e, False)))
                else:
                    kernels_raw.append((name, _ns(e, True), _ns(e, False), e.correlation_id()))
            elif name in self.span_names:
                spans.setdefault(name, []).append((_ns(e, True), _ns(e, False)))
            elif name.startswith("cu"):  # a CUDA runtime or driver call: a launch's host side, its id the kernel's
                launches[e.correlation_id()] = _ns(e, True)
                if "LaunchKernel" in name:
                    launch_calls.add(e.correlation_id())
        if not kernels_raw:
            kinds: Dict[str, int] = {}
            for e in events:
                key = f"{e.device_type()}"
                kinds[key] = kinds.get(key, 0) + 1
            raise RuntimeError("the profiled stretch holds no kernel record on the device; its time was not "
                               f"recorded (events by device: {kinds})")
        kernels = [Kernel(family(n), a, b, launches.get(c)) for n, a, b, c in kernels_raw]
        unlinked = sum(k.launch is None for k in kernels)
        dropped = len(launch_calls - {c for *_, c in kernels_raw})
        if unlinked or dropped:
            print(f"trace: {unlinked} of {len(kernels)} kernels without a launch record, {dropped} of "
                  f"{len(launch_calls)} launches without a kernel record", file=sys.stderr)
        starts = [a for ss in spans.values() for a, _ in ss]
        lo = min(starts) if starts else min(k.start for k in kernels)
        hi = max([k.end for k in kernels] + [b for _, b in other])
        return Trace(kernels, other, spans, (lo, hi), units, {"dropped": dropped})
