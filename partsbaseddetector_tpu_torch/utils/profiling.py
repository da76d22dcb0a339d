"""Observability: stage timing, device profiling, numeric guards, input
validation.

The torch counterpart of `partsbaseddetector_tpu/utils/profiling.py`
(the reference has no systematic tracing: ad-hoc cv::getTickCount
prints, SURVEY.md §5):

  - Timer: wall-clock harness with named stages; a stage given a result
    synchronizes the CUDA devices its tensors live on (the JAX
    package's block_until_ready);
  - time_fn(): median steady-state latency of a call (the counterpart of
    time_jitted: the port has no jit);
  - trace(): context manager around torch.profiler that writes a Chrome
    trace (chrome://tracing, Perfetto);
  - checked(): wraps a function so that the first op that makes a NaN
    raises (the counterpart of the JAX package's checkify guards);
  - device_op_breakdown(): device ms per call by op family, and the
    finer per-kernel families of the port's kernels (device_profile,
    kernel_family), which chip_smoke.py reports;
  - cuda_ms(), device_ms(): the CUDA-event and profiler timers of the
    tools and chip_smoke.py;
  - validate_image(): input validation for the public detect API.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np


def _tensors(obj):
    """The torch tensors in a (nested) result of tensors, lists, tuples
    and dicts."""
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of `result`."""
    import torch

    for dev in {t.device for t in _tensors(result) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating wall-clock timer with named stages."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            synchronize(result)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.times.setdefault(name, []).append(seconds)

    def summary(self) -> Dict[str, float]:
        return {k: float(np.median(v)) for k, v in self.times.items()}

    def report(self) -> str:
        return "\n".join(
            f"{k}: {v * 1000:.2f} ms" for k, v in self.summary().items()
        )


def time_fn(fn: Callable, *args, iters: int = 5) -> float:
    """Median steady-state latency in seconds of fn(*args), after one
    warm-up call, each call waited for on the CUDA devices of its
    output. The counterpart of the JAX package's time_jitted: the port
    runs eagerly and has no jit."""
    synchronize(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        synchronize(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (CPU activity, and CUDA
    activity when a card is present) and write a Chrome trace to
    `logdir/trace.json`. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def checked(fn: Callable):
    """Wrap fn so that it raises on the first op that makes a NaN,
    instead of propagating it.

    Every torch op that fn runs is watched (a TorchDispatchMode): when a
    floating output of an op holds a NaN and none of the op's floating
    inputs held one, FloatingPointError names the op (0/0, inf - inf,
    sqrt or log of a negative number). A NaN that came in with the
    inputs passes on. This is the JAX package's checkify rule
    (float_checks); out-of-range indexing already raises in torch, and
    so does integer division by zero on the CPU. Each op's outputs are
    read on the host, so a wrapped call on the card is slow: a debugging
    aid."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    def has_nan(tensors) -> bool:
        return any(
            t.is_floating_point() and bool(torch.isnan(t).any())
            for t in tensors
        )

    class NanCheck(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if has_nan(_tensors(out)) and not has_nan(
                _tensors((args, kwargs))
            ):
                raise FloatingPointError(f"{func} produced a NaN")
            return out

    def wrapper(*args, **kwargs):
        with NanCheck():
            return fn(*args, **kwargs)

    return wrapper


# The port's kernels by a piece of their name (first match wins: K5 is
# the DT core's kernel with the tag dt1d_window, K1 the same kernel with
# dt1d_exact; the backward's name contains the forward's).
FAMILIES = (("dt1d_window", "dt1d_window"), ("dt1d_bwd", "dt1d_axis2_bwd"),
            ("dt1d", "dt1d_axis2"), ("conv", "conv3xtf32"),
            ("transpose", "transpose32"), ("fft", "fft"))

# device_op_breakdown's families (the JAX package's names) from the
# finer ones above; T2 is a transposed copy, where XLA's transposes are
# its copy ops
BREAKDOWN = {"dt1d_window": "dt_kernels", "dt1d_bwd": "dt_kernels",
             "dt1d": "dt_kernels", "conv": "conv",
             "transpose": "async_copies_overlapped", "fft": "other"}


def kernel_family(name: str) -> str:
    """The FAMILIES key of a device event's name, or "other"."""
    low = name.lower()
    return next((k for k, piece in FAMILIES if piece in low), "other")


def op_family(name: str) -> str:
    """device_op_breakdown's family of a device event's name:
    dt_kernels (K1, K3's x pass, K4, K5), conv (K2),
    async_copies_overlapped (copies and memsets, and T2),
    fused_elementwise_hog_dp (torch's elementwise and reduction
    kernels: HOG, the pyramid, the DP's glue) or other."""
    fam = kernel_family(name)
    if fam != "other":
        return BREAKDOWN[fam]
    low = name.lower()
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "async_copies_overlapped"
    if "elementwise" in low or "reduce" in low:
        return "fused_elementwise_hog_dp"
    return "other"


def _device_events(prof) -> list:
    """The device-side events of a torch.profiler run (kernels,
    copies); the aten ops that launched them carry the same time
    again."""
    import torch

    return [
        e for e in prof.key_averages()
        if _dev_us(e) and e.device_type == torch.autograd.DeviceType.CUDA
    ]


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def device_profile(prof, per: float = 1.0) -> dict:
    """Device ms of a profiled window by kernel family (FAMILIES, then
    "other"), divided by `per` (images or steps), with the busy total,
    the device ops and the busiest kernels."""
    kernels = _device_events(prof)
    families = {k: 0.0 for k, _ in FAMILIES}
    families["other"] = 0.0
    for e in kernels:
        families[kernel_family(e.key)] += _dev_us(e) / 1e3 / per
    top = sorted(kernels, key=_dev_us, reverse=True)[:6]
    return {
        "families": families, "busy": sum(families.values()),
        "ops": sum(e.count for e in kernels) / per,
        "top": " | ".join(
            f"{e.key[:48]} {_dev_us(e) / 1e3 / per:.3f}ms x{e.count / per:g}"
            for e in top),
    }


def device_op_breakdown(fn, *args, iters: int = 5) -> Dict[str, float]:
    """Profile `fn(*args)` and attribute device time by op family.

    Returns {family: device ms per call} over `iters` calls after a
    warm-up, in op_family's families, largest first: in-program
    numbers, unlike wall-clock timing. Copies on a stream of their own
    overlap compute, so the families need not sum to the wall time.
    Returns {} when the profiler saw no device time (on the CPU, or
    when profiling is unavailable)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return {}
    try:
        synchronize(fn(*args))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
        tot = collections.Counter()
        for e in _device_events(prof):
            tot[op_family(e.key)] += _dev_us(e)
        return {k: v / 1e3 / iters for k, v in tot.most_common()}
    except RuntimeError:
        return {}


def validate_image(im: np.ndarray, min_side: Optional[int] = None) -> np.ndarray:
    """Public-API input validation (the reference demo exits on bad
    input, src/demo.cpp:90-99)."""
    im = np.asarray(im)
    if im.ndim == 2:
        im = np.repeat(im[:, :, None], 3, axis=2)
    if im.ndim != 3 or im.shape[2] not in (1, 3):
        raise ValueError(f"expected (H, W, 3) image, got shape {im.shape}")
    if im.shape[2] == 1:
        im = np.repeat(im, 3, axis=2)
    # integer/bool frames are always finite; floats are checked in
    # their own dtype; anything else (complex, object, ...) is rejected
    # outright, since silently dropping imaginary parts would be worse
    if np.issubdtype(im.dtype, np.floating):
        if not np.isfinite(im).all():
            raise ValueError("image contains NaN/Inf")
    elif not (
        np.issubdtype(im.dtype, np.integer) or im.dtype == np.bool_
    ):
        raise ValueError(f"unsupported image dtype: {im.dtype}")
    if min_side and min(im.shape[:2]) < min_side:
        raise ValueError(
            f"image side {min(im.shape[:2])} below minimum {min_side}"
        )
    return im


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time in ms of fn() over reps calls on the current CUDA
    stream, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 50) -> float:
    """Mean device-busy time in ms of fn() over reps calls, from
    torch.profiler's device-side events (kernels and copies). Unlike
    `cuda_ms` it leaves out the gaps between launches, which dominate
    event timings of kernels that take less than the host needs to
    launch one (~10 us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return total_us / 1e3 / reps
