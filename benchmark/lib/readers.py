"""The arithmetic of the metric readers, shared by the readers of one
quantity in several cells (benchmark/metrics/<name>.py). A reader
returns None where its cell has nothing for it to read."""

from __future__ import annotations

import statistics

from . import work


def quantile(values, q: int):
    """The q-th percentile (inclusive method), None without values."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def frame_ms(ctx, q: int):
    """The q-th percentile ms of the window's requests, where every
    request is one frame."""
    if ctx.per_request != 1:
        return None
    v = quantile(ctx.latencies_s, q)
    return None if v is None else 1e3 * v


def images_per_s(ctx):
    return ctx.images / ctx.window_s if ctx.window_s > 0 else None


def device_ops_per_image(ctx):
    w = ctx.window
    return None if w is None else w.ops / w.images


def window_s_per_image(ctx):
    """Wall seconds an image over the untraced window: the profiler's
    tracing slows the traced request itself (PERF.md)."""
    return ctx.window_s / ctx.images if ctx.images and ctx.window_s > 0 else None


def host_gap_ms_per_image(ctx):
    """ms an image in which the device is idle: the window's wall time
    an image less the traced request's device-busy time an image."""
    w, wall = ctx.window, window_s_per_image(ctx)
    return None if w is None or wall is None else 1e3 * (wall - w.busy_s / w.images)


def device_busy_ms_per_image(ctx):
    w = ctx.window
    return None if w is None else 1e3 * w.busy_s / w.images


def device_idle_share(ctx):
    """Percent of the window's wall time an image in which the device is
    idle, by the traced request's device-busy time an image."""
    w, wall = ctx.window, window_s_per_image(ctx)
    return None if w is None or wall is None else 100.0 * (1.0 - w.busy_s / w.images / wall)


def roofline(ctx, family: str, bound_s):
    """Percent: the least time of the window's work (bound_s(cfg,
    images)) over the family's device time in the window."""
    w = ctx.window
    spent = None if w is None else w.family_s.get(family, 0.0)
    if not spent:
        return None
    return 100.0 * bound_s(ctx.cfg, w.images) / spent


def step_mfu(ctx):
    """Percent of the f32 profile's peak (3xTF32, 165 TFLOP/s) that the
    window's images' model FLOPs take over the whole window."""
    if ctx.window_s <= 0 or not ctx.images:
        return None
    return 100.0 * work.model_flops(ctx.cfg) * ctx.images / (
        ctx.window_s * work.F32_PROFILE_FLOPS)
