"""Observability: stage timing, device profiling, numeric guards, input
validation.

The torch counterpart of `partsbaseddetector_tpu/utils/profiling.py`
(the reference has no systematic tracing: ad-hoc cv::getTickCount
prints, SURVEY.md §5):

  - Timer: wall-clock harness with named stages; a stage given a result
    synchronizes the CUDA devices its tensors live on (the JAX
    package's block_until_ready);
  - span(), recording(): the program's stage spans (the detect path's
    stages, named in the docstring of span), off unless a recording()
    is open, on the clock of torch.profiler's events;
  - time_fn(): median steady-state latency of a call (the counterpart of
    time_jitted: the port has no jit);
  - trace(): context manager around torch.profiler that writes a Chrome
    trace (chrome://tracing, Perfetto);
  - checked(): wraps a function so that the first op that makes a NaN
    raises (the counterpart of the JAX package's checkify guards);
  - device_profile(), kernel_family(): device ms of a profiled window
    by family of the port's kernels;
  - window(), launch_counts(), require_launches(), profiled(): the
    profiler window every reading here takes, the hand kernels'
    launches by family as their wrappers count them into the launch
    registry `hand_launches`, and the check that a window recorded a
    kernel event for each;
  - dp_graph_counts(), pyramid_graph_counts(), tail_graph_counts(): the
    inference DP's, pyramid's and tail's CUDA-graph captures, replays
    and eager calls;
  - tree_counts(): the detect path's images, (bucket, tree) DPs, walks
    and candidate rows, as detector.py's _run adds them up;
  - cuda_ms(), device_ms(): the CUDA-event and profiler timers of the
    tools;
  - validate_image(): input validation for the public detect API.

Every counter here is a module dict that the layers above add to; this
module imports nothing of theirs.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

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


# -- stage spans -------------------------------------------------------------


class Span(NamedTuple):
    """One finished span. Times are time.time_ns(), the unix-ns clock of
    torch.profiler's events (Kineto's start_ns(), the CUDA runtime's
    records among them), so a span can be laid over a profile."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]  # None at a root
    request: int  # the root's id
    images: Optional[int]  # a root's images; None below a root


class Recording:
    """The spans that finished while it was on, the newest SPAN_CAP of
    them: `spans` in the order they ended, and `dropped`, the older
    spans let go to keep within the cap. Each thread keeps its own
    stack of open spans, so a span opened on a worker thread with none
    open there is a root of its own."""

    def __init__(self):
        self.dropped = 0
        self._done: deque = deque(maxlen=SPAN_CAP)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    @property
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._done)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _finish(self, span: Span) -> None:
        with self._lock:
            if len(self._done) == self._done.maxlen:
                self.dropped += 1
            self._done.append(span)


class _OpenSpan:
    __slots__ = ("_rec", "_name", "_images", "_id", "_parent", "_request", "_start")

    def __init__(self, rec: Recording, name: str, images: Optional[int]):
        self._rec, self._name, self._images = rec, name, images

    def __enter__(self):
        stack = self._rec._stack()
        self._id = next(self._rec._ids)
        if stack:
            top = stack[-1]
            self._parent, self._request, self._images = top._id, top._request, None
        else:
            self._parent, self._request = None, self._id
        stack.append(self)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._rec._stack().pop()
        self._rec._finish(Span(self._name, self._start, end, self._id, self._parent,
                               self._request, self._images))
        return False


class _NoSpan:
    """span()'s object while no recording is open: its enter and exit
    are static, so a with-block over it allocates nothing."""

    __slots__ = ()

    @staticmethod
    def __enter__():
        return None

    @staticmethod
    def __exit__(*exc):
        return False


NO_SPAN = _NoSpan()
SPAN_CAP = 1 << 16
_recording: Optional[Recording] = None
_recording_lock = threading.Lock()


def span(name: str, images: Optional[int] = None):
    """A context manager that records one span of `name` while a
    recording() is open; otherwise NO_SPAN, after one read of a module
    global: no allocation, no clock read. `images`: the images a root
    span's request covers (ignored below a root).

    The detect path's spans (32 in a person26 VGA detect, whose ten
    buckets give ten mask and ten dp spans):

        roots      detect, detect_many, detect_batch (with images)
        transfers  upload (staging and the copy up; on the pipelined
                   path's uploader thread a root of its own), pack (the
                   device-side packer), readback (the copy down and its
                   wait), assemble (candidates from the host rows, the
                   host depth filter included)
        pipeline   pyramid (the HOG pyramid), conv (the part-filter
                   responses: K2's grouped launch, or each bucket's
                   engine call), mask (each bucket's masking and gates),
                   dp (one tree DP: a bucket and a component)
        tail       backtrack (the backtracks and their concatenation),
                   select (top-k, the f32 re-score, device NMS, the
                   final gathers, the device depth keep mask)
    """
    rec = _recording
    if rec is None:
        return NO_SPAN
    return _OpenSpan(rec, name, images)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Turn spans on for the process and yield the Recording that
    collects them; one recording at a time. An operator reads a stage's
    time as the sum of its spans' end_ns - start_ns in each request
    (spans sharing a root's id), over the root's images."""
    global _recording
    rec = Recording()
    with _recording_lock:
        if _recording is not None:
            raise RuntimeError("spans are already being recorded")
        _recording = rec
    try:
        yield rec
    finally:
        with _recording_lock:
            _recording = None


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

# The launch registry: each wrapper of ops/*_cuda.py adds one to its
# family a launch (the plain versions count nothing). "dt1d" counts K1
# and K3's x passes, "dt1d_aux" those x passes again, "dt1d_window" K5,
# "dt1d_bwd" K4, "conv" K2 and T1 (both conv3xtf32 kernels), "transpose"
# T2. A CUDA graph's capture runs the wrappers and launches nothing, a
# replay launches and runs no wrapper: ops/dp_graph.py::ShapeGraph takes
# a capture's counts back off and adds them again at each replay.
hand_launches: Dict[str, int] = dict.fromkeys(HAND_FAMILIES, 0)


def kernel_family(name: str) -> str:
    """The FAMILIES key of a device event's name, or "other"."""
    low = name.lower()
    return next((k for k, piece in FAMILIES if piece in low), "other")


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
    """The hand kernels' launches so far, by HAND_FAMILIES: a copy of
    the launch registry `hand_launches`."""
    return dict(hand_launches)


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add `times` x counts (by HAND_FAMILIES keys) to the registry."""
    for fam, n in counts.items():
        hand_launches[fam] += times * n


# the inference DP's, pyramid's and tail's calls by how they ran, which each
# ops/dp_graph.py::ShapeGraph counts in
dp_graph_calls: Dict[str, int] = {"captures": 0, "replays": 0, "eager": 0}
pyramid_graph_calls: Dict[str, int] = {"captures": 0, "replays": 0, "eager": 0}
tail_graph_calls: Dict[str, int] = {"captures": 0, "replays": 0, "eager": 0}


def dp_graph_counts() -> Dict[str, int]:
    """The inference DP's calls so far by how they ran
    (ops/dp_graph.py): `captures` (a shape's second call, captured as a
    CUDA graph and replayed once), `replays` and `eager` (a shape's
    first call, and every call the graph does not engage for: CPU maps,
    trainable weights, autograd on). The graph's hit share is replays
    over the three."""
    return dict(dp_graph_calls)


def pyramid_graph_counts() -> Dict[str, int]:
    """The inference pyramid's calls so far by how they ran
    (ops/dp_graph.py::PyramidGraph), as dp_graph_counts() counts the
    DP's: `captures`, `replays` and `eager` (a shape's first call, and
    every call with a graph that it does not engage for). The graph's
    hit share is replays over the three."""
    return dict(pyramid_graph_calls)


def tail_graph_counts() -> Dict[str, int]:
    """The inference tail's calls so far by how they ran
    (ops/dp_graph.py::TailGraph: the backtrack walks and the select
    after the DP): `captures` (at a shape's second call, the DP's
    capture), `replays` and `eager` (a shape's first call, and every
    call whose DP did not run as its graph: CPU maps, or a detector
    that ran without graphs). The graph's hit share is replays over the
    three."""
    return dict(tail_graph_calls)


# the detect path's work by tree so far: detector.py's _run adds to it
tree_work: Dict[str, int] = {
    "images": 0, "dp_pairs": 0, "dp_groups": 0, "walks": 0, "tail_rows": 0,
}


def tree_counts() -> Dict[str, int]:
    """What the detect path's `_run` calls did so far, host integers
    counted without a device sync: `images`; `dp_pairs`, the (bucket,
    tree) DPs it scheduled, whether a graph captured, replayed or ran
    them eagerly; `dp_groups`, the level groups those DPs ran in
    (ops/dp.py::dp_plan's: one batched DT each, across every tree a
    bucket scores, so the trees' depth a bucket where all parts share
    one grid and mixture count); `walks`, its `backtrack_merged` and
    `backtrack` calls; `tail_rows`, the candidate rows of every image
    concatenated across trees before the top-k (`select`)."""
    return dict(tree_work)


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
