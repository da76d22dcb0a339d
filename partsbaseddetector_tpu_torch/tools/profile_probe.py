"""Count the kernel records torch.profiler keeps in windows of one lone
launch: the measurements behind utils/profiling.py::window, the kernel
library's `-cudart shared` and the order of chip_smoke.py's phases
(PERF.md §6).

    python -m partsbaseddetector_tpu_torch.tools.profile_probe [--windows 20]

Each window holds one bare launch of K1 (`dt_cuda._dt1d_cuda`, person26
VGA's y pass (80, 126, 166)), of K2 (`conv_cuda._grouped_cuda`, one
(5, 130, 170, 32) stack, 104 filters of 5x5x32) or of one torch kernel
(an in-place add); the probe counts the windows that kept its record.
In turn:

  start    plain profiler windows and utils/profiling.py::window, on
           the shipped library (`-cudart shared`) and on a copy of the
           same sources linked to nvcc's default static runtime
  detect   person26 VGA detect with each library in turns: ms per image,
           and the candidates bit for bit
  trigger  one window over three person26 VGA detects, as chip_smoke.py's
           `profile` takes it
  after    the windows of `start` on the shipped library again, then
           window() opened by a spin of 20 and of 100 ms instead of a
           short one, and five checked windows of one VGA detect
           (utils/profiling.py::profiled)
  fresh    `start` in a new process (the same script, --start-only)

Prints a line per measurement, the card's name and power limit, then one
JSON object.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

from .. import kernels

ROOT = Path(__file__).resolve().parents[2]


def static_copy() -> ctypes.CDLL:
    """The shipped sources linked to nvcc's default static CUDA runtime
    (one nvcc), beside the shipped library, bound as kernels.library()
    binds it."""
    out = kernels.library_path()
    out = out.with_name(out.stem + "_static.so")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        flags = [f for f in kernels.NVCC_FLAGS if f not in ("-cudart", "shared")]
        tmp = out.with_suffix(".tmp")
        subprocess.run([kernels._nvcc(), *flags, "-cudart", "static", "-o", str(tmp),
                        *map(str, kernels.sources())], check=True, capture_output=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, (args, res) in kernels._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


@contextlib.contextmanager
def plain(torch):
    """A profiler window with no opener and no pads."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def kept(torch, launch, piece: str, n: int, window) -> int:
    """Of n windows (window() each) of one launch(), how many kept a
    kernel record whose name holds `piece`."""
    launch()
    got = 0
    for _ in range(n):
        with window() as prof:
            launch()
        got += any(e.device_type == torch.autograd.DeviceType.CUDA and piece in e.key
                   for e in prof.key_averages())
    return got


def launches(torch, gen):
    """The three lone launches: (run, piece of the kernel's name)."""
    from ..ops import conv_cuda, dt_cuda

    src = (3 * torch.randn((80, 126, 166), generator=gen)).cuda()
    a = -(0.01 + 0.05 * torch.rand((80,), generator=gen)).cuda()
    b = (0.3 * torch.randn((80,), generator=gen)).cuda()
    shift = torch.randint(-3, 4, (80,), generator=gen).float().cuda()
    nvalid = torch.full((80,), 126, dtype=torch.int32).cuda()
    feat = torch.rand((5, 130, 170, 32), generator=gen).cuda()
    filt = (0.1 * torch.randn((104, 5, 5, 32), generator=gen)).cuda()
    bank = conv_cuda.split_bank(filt)
    scratch = src.clone()
    return {
        "K1": (lambda: dt_cuda._dt1d_cuda(src, a, b, shift, nvalid, 126, 1, None),
               "dt1d_axis2"),
        "K2": (lambda: conv_cuda._grouped_cuda([feat], filt, bank), "conv3xtf32"),
        "add": (lambda: scratch.add_(1.0), "add"),
    }


def lone(torch, runs: dict, libs: dict, windows: dict, n: int, stage: str) -> dict:
    """kept() of every run on every library in every kind of window."""
    from ..utils import profiling

    out, saved = {}, kernels._lib
    try:
        for lib_name, lib in libs.items():
            kernels._lib = lib
            for name, (run, piece) in runs.items():
                if name == "add" and lib_name != next(iter(libs)):
                    continue
                for win_name, (win, cycles) in windows.items():
                    profiling.OPENER_CYCLES = cycles
                    key = f"{lib_name}/{name}/{win_name}"
                    out[key] = kept(torch, run, piece, n, win)
                    print(f"[{stage}] {key} kept={out[key]}/{n}", flush=True)
    finally:
        kernels._lib = saved
        profiling.OPENER_CYCLES = 1000
    return out


def cycles_per_ms(torch) -> float:
    """torch.cuda._sleep's clock cycles in one ms, by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def person26(torch):
    """A person26 detector (two buckets per octave) and a seeded VGA
    frame, one detect done."""
    from .. import PartsBasedDetector, make_person_like_model

    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2)
    im = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0)).numpy()
    det.detect(im)
    return det, im


def detect_turns(torch, det, im, libs: dict, turns: int = 2) -> dict:
    """The detect with each library in turns (static, shared, shared,
    static): the median ms of 5 detects a turn, and whether every turn's
    candidates equal the first's bit for bit."""
    import numpy as np

    key = lambda cands: [(c.score, c.parts.tobytes(), c.component,
                          np.asarray(c.mixtures).tobytes()) for c in cands]
    ms, first, same, saved = {k: [] for k in libs}, None, True, kernels._lib
    try:
        for kind in ("static", "shared", "shared", "static") * turns:
            kernels._lib = libs[kind]
            got = key(det.detect(im))
            first = got if first is None else first
            same = same and got == first
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                det.detect(im)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[kind].append(round(statistics.median(times), 3))
    finally:
        kernels._lib = saved
    out = {"ms_per_image": ms, "candidates": len(first), "same_candidates": same}
    print("[detect] " + json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=20)
    ap.add_argument("--start-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    from ..utils import profiling

    if not torch.cuda.is_available():
        print("profile_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.zeros(1, device="cuda")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        static = pool.submit(static_copy)
        kernels.library()
        libs = {"shared": kernels.library(), "static": static.result()}
    runs = launches(torch, torch.Generator().manual_seed(0))
    start_windows = {"plain": (lambda: plain(torch), 1000), "window": (profiling.window, 1000)}
    result = {"card": card,
              "start": lone(torch, runs, libs, start_windows, args.windows, "start")}
    if args.start_only:
        print(json.dumps(result))
        return 0
    det, im = person26(torch)
    result["detect"] = detect_turns(torch, det, im, libs)
    with profiling.window():
        for _ in range(3):
            det.detect(im)
    per_ms = cycles_per_ms(torch)
    after_windows = {**start_windows,
                     "spin_20ms": (profiling.window, int(20 * per_ms)),
                     "spin_100ms": (profiling.window, int(100 * per_ms))}
    result["after"] = lone(torch, runs, {"shared": libs["shared"]}, after_windows,
                           args.windows, "after")
    complete, first_error = 0, None
    for _ in range(5):
        try:
            profiling.profiled(lambda: det.detect(im))
            complete += 1
        except RuntimeError as e:
            first_error = first_error or str(e)
    result["detect_windows"] = {"complete": complete, "of": 5, "first_error": first_error}
    print("[after] detect_windows " + json.dumps(result["detect_windows"]), flush=True)
    proc = subprocess.run([sys.executable, "-m", "partsbaseddetector_tpu_torch.tools."
                           "profile_probe", "--windows", str(args.windows), "--start-only"],
                          capture_output=True, text=True, cwd=ROOT, timeout=600)
    result["fresh"] = json.loads(proc.stdout.strip().splitlines()[-1])["start"]
    print("[fresh] " + json.dumps(result["fresh"]), flush=True)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
