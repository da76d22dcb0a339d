"""One profiled request: the device's work and the host's gaps in it.

A window covers one request of the cell's traffic (one detect, or one
microbatch group). torch.profiler records the device's side only
(ProfilerActivity.CUDA: kernels, copies and memsets, and the CUDA
runtime calls that the host made), not the host's torch ops, whose
recording would slow the request it measures; the host clock times the
request. From them:

    wall_s      the request's host-clock time, from its call to the end
                of its last device op (a synchronize follows it)
    busy_s      the union of the device events' intervals
    ops         device events in the window
    family_s    device seconds by kernel family (the program's kernels
                by a piece of their name, FAMILIES)
    device_ops  the device events that took most time, by name
    idle_gaps   the idle time between device events, by the CUDA
                runtime call that the host was in at each gap's middle
                ("host (python)" outside any), and the host time before
                the first and after the last device op

torch.profiler can drop kernel records (it files some outside its
window). Every window is therefore held to the program's launch
counters: the kernel events of each hand-kernel family must equal the
launches its wrappers counted over the window, or the window raises
IncompleteProfile and the run fails instead of reporting a number.

The window opens with a throwaway spin kernel, left out of every
reading, and is held open 10 ms on either side of the request.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import time
from typing import Callable, Dict, List, Tuple

# kernel families by a piece of the kernel's name, first match wins (K5
# is the DT core with the tag dt1d_window, K4's name holds K1's)
FAMILIES = (("dt1d_window", "dt1d_window"), ("dt1d_bwd", "dt1d_axis2_bwd"),
            ("dt1d", "dt1d_axis2"), ("conv", "conv3xtf32"),
            ("transpose", "transpose32"), ("fft", "fft"))
HAND_FAMILIES = ("dt1d_window", "dt1d_bwd", "dt1d", "dt1d_aux", "conv", "transpose")
OPENER = "spin_kernel"
PAD_S = 0.01
TOP = 10
NAME_CHARS = 96


class IncompleteProfile(RuntimeError):
    """The profiler recorded other kernel events than the wrappers
    launched."""


def kernel_family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, piece in FAMILIES if piece in low), "other")


def has_aux(name: str) -> bool:
    """Whether a dt1d kernel is the instance that carries aux (the x
    pass), by its demangled or mangled name."""
    return "dt1d_axis2_kernel<true" in name or "dt1d_axis2_kernelILb1E" in name


@dataclasses.dataclass
class Window:
    images: int
    wall_s: float
    busy_s: float
    ops: int
    family_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """Merged intervals clipped to [lo, hi], in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(merged, lo: float, hi: float) -> List[Tuple[float, float]]:
    edges = [lo] + [x for m in merged for x in m] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def innermost(ops: List[Tuple[float, float, str]], points: List[float]) -> List[str]:
    """For each point (ascending), the name of the innermost op (start,
    end, name) that contains it, or "host (python)"."""
    ops = sorted(ops)
    starts = [o[0] for o in ops]
    out = []
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for t in points:
        j = bisect.bisect_right(starts, t)
        while i < j:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host (python)")
    return out


def read_window(events, images: int, counted: Dict[str, int], wall_s: float) -> Window:
    """The readings of one window from torch.profiler's events (times in
    microseconds), held to the launches the wrappers counted; `wall_s`
    is the request's time on the host clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # device work only: not the opener, nor GPU-side copies of host
    # annotations, which span whole ranges
    dev = [e for e in events if e.device_type == cuda and OPENER not in e.name
           and not getattr(e, "is_user_annotation", False)]
    family_s = collections.Counter()
    launches = collections.Counter()
    by_name = collections.Counter()
    for e in dev:
        dur = (e.time_range.end - e.time_range.start) / 1e6
        fam = kernel_family(e.name)
        family_s[fam] += dur
        by_name[e.name[:NAME_CHARS]] += dur
        if fam in HAND_FAMILIES:
            launches[fam] += 1
            if fam == "dt1d" and has_aux(e.name):
                launches["dt1d_aux"] += 1
    for fam in HAND_FAMILIES:
        if launches[fam] != counted.get(fam, 0):
            raise IncompleteProfile(
                f"{fam}: the profile recorded {launches[fam]} kernel events, the "
                f"wrappers launched {counted.get(fam, 0)}")
    if not dev:
        raise IncompleteProfile("no device event in the window")
    merged = union([(e.time_range.start, e.time_range.end) for e in dev], -math.inf, math.inf)
    busy = sum(b - a for a, b in merged) / 1e6
    lo, hi = merged[0][0], merged[-1][1]
    idle = gaps(merged, lo, hi)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type != cuda and OPENER not in e.name]
    named = innermost(host, [(a + b) / 2 for a, b in idle])
    gap_s = collections.Counter()
    for (a, b), name in zip(idle, named):
        gap_s[name[:NAME_CHARS]] += (b - a) / 1e6
    edges = wall_s - (hi - lo) / 1e6
    if edges > 0:
        gap_s["host before the first and after the last device op"] += edges
    return Window(images=images, wall_s=max(wall_s, busy), busy_s=busy, ops=len(dev),
                  family_s=dict(family_s),
                  device_ops=by_name.most_common(TOP), idle_gaps=gap_s.most_common(TOP))


def profile_request(request: Callable[[], object], images: int,
                    launch_counts: Callable[[], Dict[str, int]]) -> Window:
    """Profile one call of `request` (which waits for its results)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        time.sleep(PAD_S)
    after = launch_counts()
    counted = {k: after[k] - before[k] for k in after}
    return read_window(prof.events(), images, counted, wall_s)
