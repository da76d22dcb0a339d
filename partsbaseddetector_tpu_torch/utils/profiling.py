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
  - window(), launch_counts(), require_launches(), profiled(): the
    profiler window every reading here takes, the hand kernels'
    launches by family as their wrappers count them, and the check
    that a window recorded a kernel event for each;
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

# the families of the hand kernels, whose launches their wrappers count
# (launch_counts), and the x passes among the dt1d launches
HAND_FAMILIES = ("dt1d_window", "dt1d_bwd", "dt1d", "dt1d_aux", "conv", "transpose")

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
    copies), those of no measurable time included, less window()'s
    opening kernel; the aten ops that launched them carry the same time
    again."""
    import torch

    return [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and OPENER not in e.key
    ]


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _has_aux(name: str) -> bool:
    """Whether a dt1d kernel's name is the instance that carries aux
    (csrc/dt1d_core.cuh's first template argument, kHasAux): K3's x
    pass, demangled or mangled."""
    return "dt1d_axis2_kernel<true" in name or "dt1d_axis2_kernelILb1E" in name


def device_profile(prof, per: float = 1.0) -> dict:
    """Device ms of a profiled window by kernel family (FAMILIES, then
    "other"), divided by `per` (images or steps), with the busy total,
    the device ops, the busiest kernels, and under "launches" the
    kernel events each family of the hand kernels (HAND_FAMILIES)
    recorded, not divided ("dt1d_aux": the dt1d events of the instance
    with aux, K3's x passes)."""
    kernels = _device_events(prof)
    families = {k: 0.0 for k, _ in FAMILIES}
    families["other"] = 0.0
    launches = {k: 0 for k in HAND_FAMILIES}
    for e in kernels:
        fam = kernel_family(e.key)
        families[fam] += _dev_us(e) / 1e3 / per
        if fam in launches:
            launches[fam] += e.count
        if fam == "dt1d" and _has_aux(e.key):
            launches["dt1d_aux"] += e.count
    top = sorted(kernels, key=_dev_us, reverse=True)[:6]
    return {
        "families": families, "busy": sum(families.values()),
        "ops": sum(e.count for e in kernels) / per, "launches": launches,
        "top": " | ".join(
            f"{e.key[:48]} {_dev_us(e) / 1e3 / per:.3f}ms x{e.count / per:g}"
            for e in top),
    }


def launch_counts() -> Dict[str, int]:
    """The hand kernels' launches so far, by HAND_FAMILIES, as their
    wrappers count them (ops/*_cuda.py; the plain
    versions count nothing): dt_cuda.launches (K1 and K3's x passes),
    of those dt_cuda.aux_launches (the x passes), window_launches (K5),
    bwd_launches (K4), transpose_cuda.launches (T2), and
    conv_cuda.launches + conv_proto_cuda.launches (K2 and T1, both
    conv3xtf32 kernels)."""
    from ..ops import conv_cuda, conv_proto_cuda, dt_cuda, transpose_cuda

    return {
        "dt1d_window": dt_cuda.window_launches,
        "dt1d_bwd": dt_cuda.bwd_launches,
        "dt1d": dt_cuda.launches,
        "dt1d_aux": dt_cuda.aux_launches,
        "conv": conv_cuda.launches + conv_proto_cuda.launches,
        "transpose": transpose_cuda.launches,
    }


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """launch_counts() less an earlier reading of it."""
    return {k: n - before[k] for k, n in launch_counts().items()}


def require_launches(profile: dict, expected: Dict[str, int]) -> None:
    """Raise RuntimeError unless a profiled window (device_profile's
    result) recorded exactly `expected[family]` kernel events in each
    family of `expected`: the launches the wrappers counted over the
    same window. Fewer events means the profile lost launches, and its
    times would read low; more means a launch no wrapper counted."""
    for fam, want in expected.items():
        got = profile["launches"].get(fam, 0)
        if got < want:
            raise RuntimeError(
                f"incomplete profile: {fam} recorded {got} kernel events, "
                f"the wrappers launched {want}")
        if got > want:
            raise RuntimeError(
                f"profile: {fam} recorded {got} kernel events, the wrappers "
                f"counted {want} launches")


# torch.profiler (Kineto over CUPTI) drops a kernel record that it files
# outside its window, torch's kernels as ours: now and then a window's
# first, and, once a process has profiled a window of whole VGA
# detects, most records of bare short windows (PERF.md §6). So every
# window of this module opens with a throwaway kernel, torch.cuda._sleep's
# spin kernel, whose record device_profile leaves out, and is held open
# WINDOW_PAD_S on either side of its work; lone windows so opened stayed
# complete in both cases. What sets off the losses is not known, so the
# readings are held to the launch counters (require_launches) all the
# same.
WINDOW_PAD_S = 0.01
OPENER = "spin_kernel"
OPENER_CYCLES = 1000


@contextlib.contextmanager
def window():
    """A torch.profiler window over the CPU and the current CUDA device,
    yielding the profiler. It opens with one throwaway kernel (a spin of
    OPENER_CYCLES clock cycles, left out of device_profile's readings),
    is held open WINDOW_PAD_S before the block and after it, and waits
    for the device before it closes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(OPENER_CYCLES)
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)


def profiled(fn, per: float = 1.0) -> dict:
    """device_profile of one profiler window over fn(), per `per`
    images or steps, held by require_launches to the launches the
    wrappers counted over the same window."""
    before = launch_counts()
    with window() as prof:
        fn()
    got = device_profile(prof, per)
    require_launches(got, launches_since(before))
    return got


def device_op_breakdown(fn, *args, iters: int = 5) -> Dict[str, float]:
    """Profile `fn(*args)` and attribute device time by op family.

    Returns {family: device ms per call} over `iters` calls after a
    warm-up, in op_family's families, largest first: in-program
    numbers, unlike wall-clock timing. Copies on a stream of their own
    overlap compute, so the families need not sum to the wall time.
    Returns {} when the profiler saw no device time (on the CPU, or
    when profiling is unavailable). The window is held by
    require_launches to the launches the wrappers counted in it."""
    import collections

    import torch

    if not torch.cuda.is_available():
        return {}
    try:
        synchronize(fn(*args))
        before = launch_counts()
        with window() as prof:
            for _ in range(iters):
                fn(*args)
        events = _device_events(prof)
    except RuntimeError:
        return {}
    require_launches(device_profile(prof), launches_since(before))
    tot = collections.Counter()
    for e in events:
        if _dev_us(e):
            tot[op_family(e.key)] += _dev_us(e)
    return {k: v / 1e3 / iters for k, v in tot.most_common()}


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


def device_ms(fn, reps: int = 50, launches: Optional[Dict[str, int]] = None) -> float:
    """Mean device-busy time in ms of fn() over reps calls, from
    torch.profiler's device-side events (kernels and copies). Unlike
    `cuda_ms` it leaves out the gaps between launches, which dominate
    event timings of kernels that take less than the host needs to
    launch one (~10 us). launches: the hand kernels' launches that one
    call of fn makes, by launch_counts' keys; when given, the profiled
    window must hold reps times as many kernel events in each of those
    families (require_launches), or RuntimeError."""
    fn()
    with window() as prof:
        for _ in range(reps):
            fn()
    got = device_profile(prof, reps)
    if launches is not None:
        require_launches(got, {k: reps * n for k, n in launches.items()})
    return got["busy"]
