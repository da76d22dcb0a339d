"""The program's stage spans in a --trace 1 run, and the device events
of one profiled request laid over them.

The port records spans at its detect path's stage boundaries when a
recorder is open (`partsbaseddetector_tpu_torch.utils.profiling.span`,
`recording`; a program without them reads nothing here). Their clock is
time.time_ns(), the unix-ns clock of torch.profiler's (Kineto's) events,
so a device event and a span compare directly.

The span metrics' readers share one measurement a process (`reading`),
made after the cell's own readings, on a system under test built anew
from the run's seed as the cell builds it (the traffic's client, its
warm-up requests), with the recorder on:

    spanned    the cell's traced request again and again (16 detects;
               4 microbatch groups: requests_for), each timed on the
               host clock
    profiled   one more, of one image only (the frame cell), under
               torch.profiler as lib/trace.py profiles a request, and
               held to the launch counters the same way

From them:

    span_ms      per request, a layer's stages' span time (the sum of
                 their durations) over the request's images; the
                 reading is the median over the spanned requests
    device_ops   the profiled request's device events by the stage that
                 issued them: the CUDA runtime call whose correlation id
                 a device event carries, and the innermost span that
                 holds the call's start ("outside" where none does, or
                 where the call has no record)
    gaps         its idle gaps between the first and the last device
                 event, named by the innermost span at their middle and
                 the runtime call there ("<span> / <call>"; a span alone
                 outside any call; lib/trace.py's name outside any span)
    unspanned_idle_share
                 percent of those gaps' time in which the host was in no
                 span below the request's root
"""

from __future__ import annotations

import argparse
import collections
import gc
import statistics
import sys
import time
from typing import Dict, List, NamedTuple, Optional

from . import inputs, port, spec as spec_mod, trace, traffic as traffic_mod

ROOTS = ("detect", "detect_many", "detect_batch")
STAGES = ("upload", "pyramid", "conv", "mask", "dp", "backtrack", "select", "pack",
          "readback", "assemble")
# the layers with a span metric, by their stages
LAYERS = {"pyramid": ("pyramid",), "dp": ("dp",), "backtrack": ("backtrack", "select"),
          "readback": ("pack", "readback", "assemble")}
OUTSIDE = "outside"
HOST = "host (python)"


def requests_for(images: int) -> int:
    """Spanned requests of a traced request of `images` images: 16
    detects, or 4 microbatch groups."""
    return 16 if images == 1 else 4


class Event(NamedTuple):
    """A profiler event: a device event (kernel, copy, memset) or a host
    record (a CUDA runtime call), times in unix ns; `correlation` ties a
    device event to the runtime call that issued it (0: none)."""

    name: str
    start_ns: int
    end_ns: int
    device: bool
    correlation: int


def events_of(prof) -> List[Event]:
    """torch.profiler's events of a CUDA-activity window as Events: the
    device events that lib/trace.py counts (less its opening kernel and
    GPU-side copies of host annotations) and every host record."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == cuda
        if device and (trace.OPENER in e.name() or e.is_user_annotation()):
            continue
        start = e.start_ns()
        out.append(Event(e.name(), start, start + e.duration_ns(), device,
                         e.correlation_id() or e.linked_correlation_id()))
    return out


def span_names(spans, points: List[float]) -> List[Optional[str]]:
    """The name of the innermost span that holds each point (ascending),
    or None."""
    names = trace.innermost([(s.start_ns, s.end_ns, s.name) for s in spans], points)
    return [None if name == HOST else name for name in names]


def stage_ops(events: List[Event], spans) -> Dict[str, int]:
    """Device events by the innermost span that held the start of the
    runtime call that issued them, OUTSIDE where none did or the call
    has no record. Every device event is counted once."""
    issued = {e.correlation: e.start_ns for e in events if not e.device and e.correlation}
    dev = [e for e in events if e.device]
    starts = sorted(issued[e.correlation] for e in dev if e.correlation in issued)
    got = collections.Counter({OUTSIDE: len(dev) - len(starts)})
    got.update(name or OUTSIDE for name in span_names(spans, starts))
    return dict(got)


def idle_gaps(events: List[Event]) -> list:
    """The (start, end) ns of the idle gaps between the first and the
    last device event."""
    merged = trace.union([(e.start_ns, e.end_ns) for e in events if e.device],
                         float("-inf"), float("inf"))
    if not merged:
        return []
    return trace.gaps(merged, merged[0][0], merged[-1][1])


def gap_labels(events: List[Event], spans) -> Dict[str, list]:
    """The idle gaps' seconds by name, as lib/trace.py names them ("was")
    and by the innermost span at their middle ("now")."""
    gaps = idle_gaps(events)
    mids = [(a + b) / 2 for a, b in gaps]
    calls = trace.innermost([(e.start_ns, e.end_ns, e.name) for e in events
                             if not e.device], mids)
    names = span_names(spans, mids)
    was, now = collections.Counter(), collections.Counter()
    for (a, b), call, name in zip(gaps, calls, names):
        was[call] += (b - a) / 1e9
        label = call if name is None else name if call == HOST else f"{name} / {call}"
        now[label] += (b - a) / 1e9
    return {"was": was.most_common(), "now": now.most_common()}


def unspanned_idle_share(events: List[Event], spans) -> Optional[float]:
    """Percent of the idle time between the first and the last device
    event in which the host was in no span below a root."""
    gaps = idle_gaps(events)
    idle = sum(b - a for a, b in gaps)
    if not idle:
        return None
    below = trace.union([(s.start_ns, s.end_ns) for s in spans if s.parent is not None],
                        float("-inf"), float("inf"))
    covered = sum(b - a for g0, g1 in gaps for a, b in trace.union(below, g0, g1))
    return 100.0 * (idle - covered) / idle


def per_request(spans) -> List[dict]:
    """Each request's root (a root span of ROOTS with images) with its
    stages' span ns: {"root": Span, "stage_ns": {stage: ns}}."""
    roots = {s.id: s for s in spans
             if s.parent is None and s.name in ROOTS and s.images}
    stage_ns = {i: collections.Counter() for i in roots}
    for s in spans:
        if s.request in roots and s.name in STAGES:
            stage_ns[s.request][s.name] += s.end_ns - s.start_ns
    return [{"root": roots[i], "stage_ns": stage_ns[i]} for i in sorted(roots)]


def span_ms(requests: List[dict], stages) -> Optional[float]:
    """The median over requests of `stages`' span ms over the request's
    images."""
    per = [sum(r["stage_ns"][s] for s in stages) / 1e6 / r["root"].images
           for r in requests]
    return statistics.median(per) if per else None


def coverage(requests: List[dict]) -> Optional[float]:
    """The median over requests of the share of the root's time that
    its stage spans cover."""
    got = [sum(r["stage_ns"].values()) / (r["root"].end_ns - r["root"].start_ns)
           for r in requests if r["root"].end_ns > r["root"].start_ns]
    return statistics.median(got) if got else None


def run_seed() -> int:
    """The run's --seed (run.py's argument); a process run without one
    has no seed to build the system from, and raises."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int)
    seed = ap.parse_known_args(sys.argv[1:])[0].seed
    if seed is None:
        raise RuntimeError("spans: no --seed among the process's arguments")
    return seed


def profile_request(request, images: int):
    """lib/trace.py's profile of one request (an opening spin kernel,
    10 ms on either side, held to the launch counters), with the
    profiler kept: (Window, profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = port.launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(trace.PAD_S)
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        time.sleep(trace.PAD_S)
    after = port.launch_counts()
    counted = {k: after[k] - before[k] for k in after}
    return trace.read_window(prof.events(), images, counted, wall_s), prof


def measure(cell: str, cfg: dict, params: dict, seed: int, device) -> Optional[dict]:
    """The spans of the cell's spanned requests (see the module
    docstring), and on a CUDA device, where a request is one image, the
    profiled request's attribution; None where the program records no
    spans."""
    import torch

    try:
        from partsbaseddetector_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    spec = spec_mod.load()
    _, client_mod = traffic_mod.load(spec.bench_dir, spec.workload(cell).traffic)
    g = inputs.generator(seed, device)
    client = client_mod.Client(params, cfg, inputs.model_arrays(cfg, g, device), g,
                               torch.device(device), {})
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else lambda: None
    try:
        client.warm()
        request, images = client.traced_request()
        host_s = []
        with recording() as rec:
            for _ in range(requests_for(images)):
                t0 = time.perf_counter()
                request()
                sync()
                host_s.append(time.perf_counter() - t0)
        reqs = per_request(rec.spans)
        out = {"requests": len(reqs), "images": images, "dropped": rec.dropped,
               "span_ms": {k: span_ms(reqs, v) for k, v in LAYERS.items()},
               "stage_ms": {s: span_ms(reqs, (s,)) for s in STAGES},
               "coverage": coverage(reqs),
               "root_ms": statistics.median(
                   (r["root"].end_ns - r["root"].start_ns) / 1e6 for r in reqs),
               "host_ms": 1e3 * statistics.median(host_s),
               "host_ms_per_image": 1e3 * statistics.median(host_s) / images}
        if images == 1 and torch.device(device).type == "cuda":
            out.update(_attribution(request, images, recording))
        return out
    finally:
        client.close()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def _attribution(request, images: int, recording) -> dict:
    # a profile that lost records raises IncompleteProfile and fails the
    # run, as lib/trace.py's does
    with recording() as rec:
        window, prof = profile_request(request, images)
    events = events_of(prof)
    ops = stage_ops(events, rec.spans)
    issued = {e.correlation for e in events if not e.device}
    return {"ops": ops, "window_ops": window.ops,
            "layer_ops": {k: sum(ops.get(s, 0) for s in v) / images
                          for k, v in LAYERS.items()},
            "unlinked": sum(1 for e in events if e.device and e.correlation not in issued),
            "gaps": gap_labels(events, rec.spans),
            "unspanned_idle_share": unspanned_idle_share(events, rec.spans)}


_MEASURED: Dict[str, Optional[dict]] = {}


def reading(ctx, *keys):
    """One number of the cell's span measurement (made at the first
    call in the process), by its keys; None where there is none."""
    if ctx.cell not in _MEASURED:
        got = measure(ctx.cell, ctx.cfg, ctx.traffic, run_seed(), "cuda")
        if got is not None and ctx.per_request and ctx.latencies_s:
            # the untraced window's, beside the spanned requests' own
            got["window_ms_per_image"] = (
                1e3 * statistics.median(ctx.latencies_s) / ctx.per_request)
        _MEASURED[ctx.cell] = got
    got = _MEASURED[ctx.cell]
    for k in keys:
        if not isinstance(got, dict) or got.get(k) is None:
            return None
        got = got[k]
    return got
