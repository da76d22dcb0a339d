"""One run of one cell: set-up, the traced request (with --trace 1), the
measured window, the comparison with the reference, the metrics.

    set-up     the model's arrays from the seed, the traffic's client
               (its inputs and the system under test), its warm-up
               requests (the first builds the kernel library)
    window     the client's load for `seconds`, tracing off
    traced     with --trace 1, one request of the window's kind under
               the profiler
    compare    the program freed, the client's answers checked against
               the reference after the window (benchmark/limits/<cell>.json
               holds each number's limit)
    metrics    the cell's end-to-end metrics (--trace 0) or per-layer
               metrics (--trace 1), each read by its own reader
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import time
from typing import List, Optional

import torch

from . import compare, inputs, port, spec as spec_mod, trace, traffic as traffic_mod


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    cell: str
    cfg: dict
    traffic: dict
    setup_s: float
    latencies_s: List[float]
    images: int
    window_s: float
    window: Optional[trace.Window]
    per_request: Optional[int] = None  # images of every request, where all have as many


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def run(spec: spec_mod.Spec, name: str, seed: int, seconds: float, traced: bool,
        device, t0: float, overrides: Optional[dict] = None,
        config_overrides: Optional[dict] = None,
        traffic_overrides: Optional[dict] = None) -> dict:
    """The result line of one run (see run.py). `overrides` replace
    detector arguments (the control's precision); `config_overrides` and
    `traffic_overrides` replace keys of those files (the tests' small
    frames and pools)."""
    marks = {"start": time.perf_counter() - t0}
    device = torch.device(device)
    cell = spec.workload(name)
    cfg = {**spec.config(cell.config), **(config_overrides or {})}
    params, client_mod = traffic_mod.load(spec.bench_dir, cell.traffic, traffic_overrides)
    ref = spec_mod.load_module(spec.reference_path(cfg), f"reference_{cfg['reference']}")
    g = inputs.generator(seed, device)
    arrays = inputs.model_arrays(cfg, g, device)
    client = client_mod.Client(params, cfg, arrays, g, device, overrides or {})
    marks["system"] = time.perf_counter() - t0
    client.warm()
    setup_s = time.perf_counter() - t0
    timed = client.window(seconds)
    window = None
    if traced:
        # after the window: the profiler leaves the host slower after it
        # has run (PERF.md), and this is the process's only profiled request
        request, n = client.traced_request()
        window = trace.profile_request(request, n, port.launch_counts)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    client.close()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    readings = client.readings(ref, random.Random(seed))
    numbers = compare.worst(readings)
    limits = spec.limits(name)
    correct = timed.failed == 0 and bool(readings) and compare.verdict(numbers, limits)
    ref_s = time.perf_counter() - t_ref

    ctx = Context(name, cfg, params, setup_s, timed.latencies_s, timed.images,
                  timed.window_s, window, timed.per_request)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(name, kind):
        value = spec_mod.load_module(m.reader_path(spec.bench_dir), f"metric_{m.name}").read(ctx)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = device_info(device, peak)
    out = {"correct": correct, "attempted": timed.images, "failed": timed.failed,
           "metrics": metrics, "device": dev}
    if window is not None:
        dev.update(busy_s=window.busy_s, window_s=window.wall_s)
        out["breakdown"] = {"device_ops": [list(x) for x in window.device_ops],
                            "idle_gaps": [list(x) for x in window.idle_gaps]}
    out["seconds"] = {"setup": setup_s, "setup_marks": marks, "window": timed.window_s,
                      "reference": ref_s, "requests": len(timed.latencies_s),
                      "answers_compared": len(readings)}
    if window is not None:
        # the profiler's cost: the traced request's wall time an image
        # over the untraced window's
        out["seconds"]["traced_over_window"] = (window.wall_s / window.images) / (
            timed.window_s / timed.images)
    finite = lambda x: x if x is not None and math.isfinite(x) else None
    out["compared"] = {k: {"value": finite(v), "limit": limits.get(k)}
                       for k, v in numbers.items()}
    return out
