"""Step profiling: capture and parse `torch.profiler` Chrome traces.

Counterpart of the JAX package's `utils/profiling.py`, with the same API.
The JAX utility reads XLA op time from an xplane trace; this one reads a
Chrome trace that `torch.profiler` exports and sums the events of one
"plane":

- on the card, the CUDA device: the trace's kernel events (`"cat": "kernel"`),
  each counted for its own duration on the device, so no host time enters;
- on the CPU, the CPU operators (`"cat": "cpu_op"`), each counted for its self
  time (its duration less that of the operators it called), the JAX
  utility's CPU fallback.

Usage:
    with capture_trace(out_dir):
        for _ in range(steps):
            run_one_step()  # ends in torch.cuda.synchronize() on the card
    table = summarize_trace(out_dir, steps=steps)
    print(format_table(table))

It also holds the port's timers, which every benchmark and timing script
imports (`tools/bench*.py`, `tools/time_train_kernels.py`, `chip_smoke.py`):
`events_ms` (CUDA events around back-to-back calls: the card's time),
`chain_s` and `wall_ms` (the host's clock to the device's finish), and
`card_line` (the card's name and power limit, as nvidia-smi gives them).

Events are aggregated into families. A CUDA kernel's name is demangled C++
(`void (anonymous namespace)::stem_tc_kernel<64, 128, unsigned char>(...)`);
its family is the base identifier, without return type, namespaces, template
arguments or parameter list (`stem_tc_kernel`), so each of the port's kernels
is a family of its own and a library's kernels group by their function.
"""

from __future__ import annotations

import glob
import json
import os
import re
import statistics
import subprocess
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

# Idle seconds on each side of the profiled window. The profiler keeps only
# the device records whose timestamps fall inside its window; minutes into a
# process, profiles of short steps came back with their runtime calls but no
# kernel (seen on an H100). The pad is idle time, which adds nothing to the
# summed kernel durations.
PAD_S = 0.25
CPU_PLANE = "cpu"


def card_line() -> str:
    """The card's name and power limit: `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`, its first line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def events_ms(fn: Callable, *, warmup: int = 3, runs: int = 20, inner: int = 1) -> float:
    """Median milliseconds of fn() over `runs` timed runs, CUDA events, each
    run the mean of `inner` back-to-back calls, after `warmup` calls. With
    inner=1 the card waits for the host to launch fn (a request from an idle
    card); a kernel's time wants inner=10 or so, so the card runs the
    launches back to back and a short kernel's time is not its launch's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def chain_s(fn: Callable, n: int, device="cuda") -> float:
    """Host seconds from the first of n back-to-back calls of fn() to the
    device's finish of the last: one synchronize after the chain, none
    between calls (on the CPU, the calls' own time)."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return time.perf_counter() - t0


def wall_ms(fn: Callable, runs: int = 20, device="cuda") -> float:
    """Median host milliseconds of fn() from an idle device to its finish,
    after three calls."""
    for _ in range(3):
        fn()
    return statistics.median(chain_s(fn, 1, device) * 1e3 for _ in range(runs))


@dataclass
class OpFamily:
    name: str
    total_ms: float  # per step
    count: int  # per step (rounded)
    example: str  # longest single event in the family


@dataclass
class TraceSummary:
    plane: str
    total_ms: float  # per step: time the plane was busy with its events
    families: List[OpFamily]
    steps: int


@contextmanager
def capture_trace(out_dir: str, *, pad_s: float = PAD_S):
    """Profile the body with `torch.profiler` (the CPU, and the card when
    there is one) and write a Chrome trace into out_dir, which is created.
    On the card the window is padded by `pad_s` idle seconds on each side and
    the device is synchronized before the trailing pad."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            time.sleep(pad_s)
        yield
        if cuda:
            torch.cuda.synchronize()
            time.sleep(pad_s)
    name = f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{time.perf_counter_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(out_dir, name))


def _latest_trace(out_dir: str) -> str:
    paths = glob.glob(os.path.join(out_dir, "**", "*.pt.trace.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .pt.trace.json under {out_dir}")
    return max(paths, key=os.path.getmtime)


def _mangled_base(name: str) -> Optional[str]:
    """The last identifier of an Itanium-mangled name's (nested) name
    (`_ZN17cutlass__5x_cudnn6KernelI...` -> `Kernel`), which the profiler
    leaves mangled where its demangler gives up; None where there is none."""
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


def _family(name: str) -> str:
    """The base identifier of a demangled C++ name (an operator's name
    without its namespace; a mangled name's last identifier); a name that is
    not C++, such as an extern "C" kernel's, is its own family."""
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


def _union_ms(spans: List[Tuple[float, float]]) -> float:
    """Milliseconds covered by the union of (start, end) microsecond spans."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def _self_times(ops: List[dict]) -> List[Tuple[dict, float]]:
    """(event, self microseconds) of nested CPU operators: each one's
    duration less its direct children's, per thread."""
    by_thread: Dict[tuple, List[dict]] = defaultdict(list)
    for e in ops:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        own = [float(e["dur"]) for e in evs]
        stack: List[int] = []
        for i, e in enumerate(evs):
            while stack and evs[stack[-1]]["ts"] + evs[stack[-1]]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                own[stack[-1]] -= float(e["dur"])
            stack.append(i)
        out += [(e, max(0.0, t)) for e, t in zip(evs, own)]
    return out


def _planes(trace: dict) -> Dict[str, List[Tuple[dict, float]]]:
    """{plane name: [(event, own microseconds)]}: one plane per CUDA device the
    trace names (its kernels; empty where none were recorded) and, when the
    trace names no device, the CPU operators."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    names = {int(p["id"]): p.get("name", "") for p in trace.get("deviceProperties") or []}
    kernels: Dict[int, list] = defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel":
            kernels[int(e.get("args", {}).get("device", 0))].append((e, float(e["dur"])))
    cuda_seen = bool(names) or any(e.get("cat") in ("cuda_runtime", "cuda_driver") for e in events)
    if cuda_seen or kernels:
        devices = sorted(set(names) | set(kernels)) or [0]
        return {f"cuda:{d} ({names.get(d, '?')})": kernels.get(d, []) for d in devices}
    return {CPU_PLANE: _self_times([e for e in events if e.get("cat") == "cpu_op"])}


def summarize_trace(out_dir: str, *, steps: int = 1, plane_filter: Optional[str] = None) -> TraceSummary:
    """Parse the newest Chrome trace under out_dir into a per-step table.

    plane_filter: substring selecting the plane ('cuda:0'); a filter that
    matches no plane raises. Default: the first CUDA device when the trace
    was taken with one, else the CPU operators. Raises when the chosen plane
    holds no events: a step never reads as 0 ms because its records are
    missing.
    """
    with open(_latest_trace(out_dir), "r", encoding="utf-8") as f:
        planes = _planes(json.load(f))
    names = list(planes)
    if plane_filter:
        names = [n for n in names if plane_filter in n]
        if not names:
            raise ValueError(f"no plane matches {plane_filter!r} (planes: {list(planes)})")
    plane = names[0]
    evs = planes[plane]
    if not evs:
        raise RuntimeError(f"plane {plane!r} holds no kernel events in the trace (planes: "
                           f"{ {n: len(v) for n, v in planes.items()} }); its time was not recorded")

    fam_us: Dict[str, float] = defaultdict(float)
    fam_cnt: Dict[str, int] = defaultdict(int)
    fam_top: Dict[str, tuple] = {}
    for e, us in evs:
        f0 = _family(e["name"])
        fam_us[f0] += us
        fam_cnt[f0] += 1
        if us > fam_top.get(f0, ("", -1.0))[1]:
            fam_top[f0] = (e["name"], us)

    steps = max(1, int(steps))
    families = [
        OpFamily(k, v / 1e3 / steps, round(fam_cnt[k] / steps), fam_top[k][0])
        for k, v in sorted(fam_us.items(), key=lambda kv: -kv[1])
    ]
    if plane == CPU_PLANE:
        busy = sum(fam_us.values()) / 1e3  # self times on a thread never overlap
    else:
        busy = _union_ms([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e, _ in evs])
    return TraceSummary(plane, busy / steps, families, steps)


def format_table(s: TraceSummary, *, top: int = 25) -> str:
    what = "CPU operator self time" if s.plane == CPU_PLANE else "on-device kernel time"
    lines = [
        f"plane: {s.plane}",
        f"{what}: {s.total_ms:.3f} ms/step ({s.steps} steps averaged)",
        f"{'ms/step':>9}  {'count':>5}  family (longest event)",
    ]
    for f in s.families[:top]:
        ex = f.example if len(f.example) <= 60 else f.example[:57] + "..."
        lines.append(f"{f.total_ms:9.3f}  {f.count:5d}  {f.name}  ({ex})")
    rest = s.families[top:]
    if rest:
        lines.append(f"{sum(f.total_ms for f in rest):9.3f}  {sum(f.count for f in rest):5d}  ... {len(rest)} more families")
    return "\n".join(lines)
