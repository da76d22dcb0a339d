"""Time the DT kernels (K1, K5, K4), the conv (K2, T1), their variants
and the transpose (T2) on the card.

A variant is a kernel's source (`csrc/dt1d.cu`, `dt1d_bwd.cu`, `conv.cu`;
the headers it includes, `dt1d_core.cuh` or `conv_core.cuh`, inlined)
with some of its `constexpr` tuning constants replaced; the transpose
and K5 are timed as they are, T1 (`csrc/conv_proto.cu`) at several toh.
With `--baseline-dir`, earlier sources of the same names (`dt1d.cu`,
`dt1d_window.cu`, `dt1d_bwd.cu`, `transpose.cu`, `conv.cu`) are timed
beside them: a redesign's before and after on the same inputs in one
process. Each source is compiled on its own (one `nvcc` each, all
started together), loaded with `ctypes`, held against the kernel's
plain version and timed by direct launches, all in turns, so that their
times compare: the profiler's device time with CUDA events' time beside
it, medians of three turns:

    python -m partsbaseddetector_tpu_torch.tools.kernel_variants
    python -m partsbaseddetector_tpu_torch.tools.kernel_variants \\
        --baseline-dir old_csrc   # also time earlier sources
    python -m partsbaseddetector_tpu_torch.tools.kernel_variants \\
        --only dt1d_window,dt1d_bwd --baseline-dir old_csrc

Shapes and rules: K1 at the person26 VGA finest bucket, y (80, 126, 166)
then x with aux (80, 166, 126), on random maps (N(0, 9) sources, a in
[-0.06, -0.01]) and on spiky maps (responses near -1 with a few peaks,
a = -0.01), bit for bit against dt1d_plain; K5 on the y and x pass of the
largest group of one person26 VGA window detect, captured on the card,
bit for bit against dt1d_window_plain and equal to K1 (timed beside it)
inside out_valid; K4 on the person26 240x320 train pair, y (320, 66, 86)
then x with aux (320, 86, 66), bit for bit against dt1d_bwd_order_plain
at the warp count the source states and the same bits on two runs (an
earlier source without that entry within 1e-5 x dt1d_bwd_magnitudes of
dt1d_bwd_plain); T2 at (80, 126, 166) and (1280, 126, 166), a single f32
array and an (f32, i32) pair, beside torch's transposed copy and a
contiguous copy of the same bytes; the conv (within 1e-5 * sum|x*w|) at
the person26 VGA table shape (5, 130, 170, 32) x (104, 5, 5, 32), and
over the ten buckets of one person26 VGA detect (buckets_per_octave=2,
the shapes captured from a detect on the card), one launch per bucket,
and for the default source also all ten in one grouped launch (the
pipeline's). The last line of the output is one JSON object with every
time in ms and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

from .. import kernels

DT_VARIANTS = {
    "default": {},
    # no chunk is skipped: staged sources and register-blocked rows only
    "no_prune": {"kPruneMaxRows": 0},
    # every candidate pays its own penalty (the path of fractional shifts)
    "no_shared_pen": {"kExactInt": 0},
    "no_prune_no_shared_pen": {"kPruneMaxRows": 0, "kExactInt": 0},
    "rows4": {"kR": 4},
    "rows4_groups16": {"kR": 4, "kMaxGroups": 16},
    "chunk8": {"kV": 8},
    "chunk32": {"kV": 32},
    "cols32": {"kCols": 32, "kMaxGroups": 8},
}


# K4's warps per map at most (the slabs of shared memory it may take
# bound them too): at the train pair's three strips, 3 warps is one
# segment a strip, 8 two, 12 four; and the rows of a load batch
DT_BWD_VARIANTS = {
    "default": {},
    "warps3": {"kMaxWarps": 3},
    "warps12": {"kMaxWarps": 12},
    "batch8": {"kBatch": 8},
}


CONV_VARIANTS = {
    "default": {},
    # output rows per block (of 128 positions): 16 x 8 instead of 8 x 16
    "rows16": {"kRows": 16},
    # a ring of three filter slices
    "stages3": {"kStages": 3},
}


def variant_source(path: Path, consts: dict) -> str:
    """path's text with the headers it includes from its own directory
    inlined (so that their constants can change and the source builds
    anywhere) and the `constexpr` constants of `consts` replaced."""
    text = path.read_text()
    for header in re.findall(r'^#include "(\w+\.cuh)"$', text, flags=re.M):
        core = (path.parent / header).read_text().replace("#pragma once", "")
        text = text.replace(f'#include "{header}"', core)
    for name, value in consts.items():
        text, n = re.subn(
            rf"(constexpr \w+ {name} = )[^;]+;", rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"{path.name}: constant {name} not found once")
    return text


def build_all(jobs: dict) -> dict:
    """{name: source text} -> {name: loaded library}; one nvcc each, all
    started together."""
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in jobs.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0 and name.endswith("_default"):
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        if proc.returncode != 0:  # a variant that does not build is reported
            print(f"[build] {name}: nvcc failed, left out:\n{log[-3000:]}", flush=True)
            continue
        used = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: " + " | ".join(used), flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bind(lib, entry: str, args=None):
    """lib's entry with the signature of kernels._SIGNATURES, or with
    `args` (an entry of an earlier source) and an int result."""
    fn = getattr(lib, entry)
    if args is None:
        fn.argtypes, fn.restype = kernels._SIGNATURES[entry]
    else:
        fn.argtypes, fn.restype = args, ctypes.c_int
    return fn


def dt_inputs(torch, kind: str, bsz: int, h: int, w: int, aux: bool, seed: int):
    gen = torch.Generator().manual_seed(seed)
    if kind == "random":
        src = torch.randn((bsz, h, w), generator=gen) * 3
        a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
    else:  # masked responses: a flat floor with a few peaks, a soft spring
        src = -1.0 + 0.1 * torch.randn((bsz, h, w), generator=gen)
        peaks = torch.rand((bsz, h, w), generator=gen) < 0.01
        src = torch.where(peaks, src + 3.0, src)
        a = torch.full((bsz,), -0.01)
    b = 0.3 * torch.randn((bsz,), generator=gen) if kind == "random" else torch.zeros(bsz)
    shift = torch.randint(-3, 4, (bsz,), generator=gen).float()
    nvalid = torch.randint(h - 6, h + 1, (bsz,), generator=gen, dtype=torch.int32)
    src = torch.where(torch.arange(h)[None, :, None] < nvalid[:, None, None],
                      src, -torch.inf)
    ax = torch.randint(0, 4096, (bsz, h, w), generator=gen,
                       dtype=torch.int32) if aux else None
    return [None if t is None else t.cuda() for t in (src, a, b, shift, nvalid, ax)]


def run_dt(torch, cuda_ms, device_ms, libs: dict) -> dict:
    from ..ops import dt_cuda

    stream = lambda: torch.cuda.current_stream().cuda_stream
    times = {}
    for kind in ("random", "spiky"):
        passes = [dt_inputs(torch, kind, 80, 126, 166, False, 1),
                  dt_inputs(torch, kind, 80, 166, 126, True, 2)]
        wants = [dt_cuda.dt1d_plain(*p[:5], p[0].shape[1], 1, aux=p[5])
                 for p in passes]

        def call(fn, p, out, ptr):
            src, a, b, shift, nvalid, ax = p
            bsz, h, w = src.shape
            rc = fn(src.data_ptr(), None if ax is None else ax.data_ptr(),
                    a.data_ptr(), b.data_ptr(), shift.data_ptr(),
                    nvalid.data_ptr(), out.data_ptr(), ptr.data_ptr(),
                    bsz, h, w, h, 1, stream())
            kernels.check(rc, "dt1d variant launch")

        fns = {name: bind(lib, "pbd_dt1d_axis2_f32") for name, lib in libs.items()}
        bufs = [(torch.empty_like(w_[0]), torch.empty_like(w_[1])) for w_ in wants]
        for name, fn in fns.items():
            for p, (out, ptr), (want_v, want_p) in zip(passes, bufs, wants):
                out.fill_(7.0)
                call(fn, p, out, ptr)
                torch.cuda.synchronize()
                live = torch.isfinite(want_v)
                if not torch.equal(out, want_v) or not torch.equal(ptr[live], want_p[live]):
                    raise AssertionError(f"dt1d variant {name} ({kind}) differs from plain")
        samples = {}
        for turn in range(3):
            for name, fn in fns.items():
                run = lambda fn=fn: [call(fn, p, *buf) for p, buf in zip(passes, bufs)]
                got = samples.setdefault(f"{name}/{kind}", {"device_ms": [], "event_ms": []})
                got["device_ms"].append(device_ms(run, reps=20, launches={"dt1d": 2}))
                got["event_ms"].append(cuda_ms(run, reps=20))
        times.update(medians(samples))
    report("dt1d", times)
    return times


def medians(samples: dict) -> dict:
    """{key: {metric: [per turn]}} -> {key: {metric: median}}: the
    middle turn. A hand kernel's window that lost events raises
    (device_ms's launches), but torch's copies and the baseline's FP32
    conv have no count to be held to, and the profiler now and then loses
    a window's events (PERF.md §6)."""
    return {key: {k: statistics.median(v) for k, v in got.items()}
            for key, got in samples.items()}


def report(family: str, times: dict) -> None:
    for key, t in times.items():
        print(f"[{family}] {key} " + " ".join(f"{k}={v:.4f}" for k, v in t.items()),
              flush=True)


def window_passes(torch, det=None, im=None) -> tuple:
    """The (y, x) K5 passes of the group with the largest maps in one
    person26 detect with the window DT (PBD_DT_WINDOW=1; by default a
    fresh detector, buckets_per_octave=2, on the seed-0 VGA frame),
    captured on the card from ops/distance_transform.py's calls of
    dt1d_window_flat. Each pass is (src, a, b, shift, nvalid, out_valid,
    dlen, aux) in the form the kernel and `dt1d_window_plain` take
    (ops/dt_cuda.py::window_args)."""
    import os

    from .. import PartsBasedDetector, make_person_like_model
    from ..ops import distance_transform as dtm

    if det is None:
        det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2)
    if im is None:
        im = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0)).numpy()
    calls = []
    orig = dtm.dt1d_window_flat

    def record(*args):
        calls.append(args + (None,) * (8 - len(args)))
        return orig(*args)

    env = os.environ.get("PBD_DT_WINDOW")
    os.environ["PBD_DT_WINDOW"] = "1"
    dtm.dt1d_window_flat = record
    try:
        det.detect(im)
    finally:
        dtm.dt1d_window_flat = orig
        if env is None:
            os.environ.pop("PBD_DT_WINDOW", None)
        else:
            os.environ["PBD_DT_WINDOW"] = env
    k = max(range(0, len(calls), 2), key=lambda j: calls[j][0].numel())
    return calls[k], calls[k + 1]


def run_window(torch, cuda_ms, device_ms, libs: dict) -> dict:
    """Every K5 source and K1 (the package's build) on the captured
    person26 passes (y, then x with aux): each K5 held to
    dt1d_window_plain bit for bit and to K1 inside out_valid, then all
    timed in turns. A K5 that differs is reported and left untimed."""
    from ..ops import dt_cuda

    stream = lambda: torch.cuda.current_stream().cuda_stream
    passes = window_passes(torch)
    wants = [dt_cuda.dt1d_window_plain(*p) for p in passes]

    def launch(fn, p, out, ptr, window: bool):
        src, a, b, shift, nvalid, ov, dlen, aux = p
        bsz, h, w = src.shape
        head = (src.data_ptr(), None if aux is None else aux.data_ptr(), a.data_ptr(),
                b.data_ptr(), shift.data_ptr(), nvalid.data_ptr())
        if window:
            rc = fn(*head, ov.data_ptr(), out.data_ptr(), ptr.data_ptr(), bsz, h, w, dlen,
                    stream())
        else:
            rc = fn(*head, out.data_ptr(), ptr.data_ptr(), bsz, h, w, dlen, 1, stream())
        kernels.check(rc, "dt1d_window variant launch" if window else "dt1d launch")

    def buffers():
        return [(torch.empty_like(v), torch.empty_like(p)) for v, p in wants]

    k1 = bind(kernels.library(), "pbd_dt1d_axis2_f32")
    k1_bufs = buffers()
    runs = {"k1": lambda: [launch(k1, p, *buf, False) for p, buf in zip(passes, k1_bufs)]}
    families = {"k1": "dt1d"}
    runs["k1"]()
    for name, lib in libs.items():
        fn, bufs = bind(lib, "pbd_dt1d_window_axis2_f32"), buffers()
        run = lambda fn=fn, bufs=bufs: [launch(fn, p, *buf, True)
                                        for p, buf in zip(passes, bufs)]
        for out, ptr in bufs:
            out.fill_(7.0), ptr.fill_(7)
        run()
        torch.cuda.synchronize()
        bad = []
        for p, (out, ptr), (want_v, want_p), (k1_v, k1_p) in zip(passes, bufs, wants, k1_bufs):
            inside = torch.arange(p[6], device="cuda")[None, :, None] < p[5][:, None, :]
            if not (torch.equal(out, want_v) and torch.equal(ptr, want_p)):
                bad.append("plain")
            if not (torch.equal(out[inside], k1_v[inside])
                    and torch.equal(ptr[inside], k1_p[inside])):
                bad.append("K1")
        if bad:
            print(f"[dt1d_window] {name} differs from {', '.join(bad)}: not timed", flush=True)
            continue
        runs[name], families[name] = run, "dt1d_window"
    samples = {}
    for turn in range(3):
        for name, run in runs.items():
            got = samples.setdefault(name, {"device_ms": [], "event_ms": []})
            got["device_ms"].append(device_ms(run, reps=20,
                                              launches={families[name]: len(passes)}))
            got["event_ms"].append(cuda_ms(run, reps=20))
    times = medians(samples)
    report("dt1d_window", times)
    exact = sum(int((torch.arange(p[6], device="cuda")[None, :, None]
                     < p[5][:, None, :]).sum()) for p in passes)
    total = sum(p[0].shape[0] * p[6] * p[0].shape[2] for p in passes)
    times["shapes"] = [f"{tuple(p[0].shape)} dlen {p[6]}" for p in passes]
    times["outputs_exact"], times["outputs_dont_care"] = exact, total - exact
    # the work the prune leaves, by the rule's torch statement: chunks
    # evaluated by a warp (two runs of 16 columns) that any lane keeps
    for label, window in (("k1", False), ("window", True)):
        times[f"warp_chunks_{label}"] = sum(
            warp_chunks(torch, dt_cuda.dt1d_chunk_keep_plain(
                *p[:5], p[6], 1, out_valid=p[5] if window else None))
            for p in passes)
    print(f"[dt1d_window] passes {times['shapes']} outputs exact {exact} "
          f"don't-care {total - exact}; chunks evaluated by warps: K1 "
          f"{times['warp_chunks_k1']}, window {times['warp_chunks_window']}", flush=True)
    return times


def warp_chunks(torch, keep) -> int:
    """(B, runs, chunks, W) kept chunks -> the chunk evaluations of the
    kernel's warps, each two consecutive runs of one 16-column tile
    (csrc/dt1d_core.cuh: kCols = 16, a warp holds 32 / kCols row groups),
    which evaluate a chunk when any of their lanes keeps it."""
    bsz, runs, chunks, w = keep.shape
    k = torch.nn.functional.pad(keep.to(torch.uint8), (0, -w % 16, 0, 0, 0, runs % 2))
    k = k.reshape(bsz, -1, 2, chunks, k.shape[-1] // 16, 16)
    return int(k.amax(dim=(2, 5)).sum())


def bwd_inputs(torch) -> list:
    """The person26 240x320 finest-bucket pair for K4: y
    (320, 66, 86), then x with aux (320, 86, 66), forward outputs from
    K1 on the card and N(0, 1) cotangents. Each case is the argument
    tuple of dt1d_bwd: (g, out, ptr, shift, h, step, has_aux)."""
    from ..ops import dt_cuda

    gen = torch.Generator().manual_seed(8)
    cases = []
    for bsz, h, w, aux in ((320, 66, 86, False), (320, 86, 66, True)):
        src = torch.randn((bsz, h, w), generator=gen) * 3
        a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
        b = 0.3 * torch.randn((bsz,), generator=gen)
        g = torch.randn((bsz, h, w), generator=gen)
        shift = torch.randint(-3, 4, (bsz,), generator=gen).float()
        ax = torch.randint(0, 4096, (bsz, h, w), generator=gen,
                           dtype=torch.int32).cuda() if aux else None
        src, a, b, g, shift = (t.cuda() for t in (src, a, b, g, shift))
        out, ptr = dt_cuda.dt1d(src, a, b, shift, h, 1, aux=ax)
        cases.append((g, out, ptr, shift, h, 1, aux))
    return cases


def run_bwd(torch, cuda_ms, device_ms, libs: dict) -> dict:
    """Every K4 source on the train pair, held first: a source that
    states its layout (pbd_dt1d_bwd_strips, pbd_dt1d_bwd_segments) to
    dt1d_bwd_order_plain at that layout bit for bit and to itself on a
    second run; an earlier one to dt1d_bwd_plain within 1e-5 x
    dt1d_bwd_magnitudes. Then timed in turns. A source that fails is
    reported and left untimed."""
    from ..ops import dt_cuda

    stream = lambda: torch.cuda.current_stream().cuda_stream
    cases = bwd_inputs(torch)
    runs, layouts = {}, {}
    for name, lib in libs.items():
        fn = bind(lib, "pbd_dt1d_axis2_bwd_f32")
        bufs = [tuple(torch.empty(shape, device="cuda") for shape in
                      ((g.shape[0], h, g.shape[2]), (g.shape[0],), (g.shape[0],)))
                for g, _, _, _, h, _, _ in cases]

        def run(fn=fn, bufs=bufs):
            for (g, out, ptr, shift, h, step, aux), res in zip(cases, bufs):
                bsz, dlen, w = g.shape
                kernels.check(fn(g.data_ptr(), out.data_ptr(), ptr.data_ptr(),
                                 shift.data_ptr(), *(t.data_ptr() for t in res),
                                 bsz, h, w, dlen, step, int(aux), stream()),
                              "dt1d_bwd variant launch")

        run()
        first = [tuple(t.clone() for t in res) for res in bufs]
        run()
        torch.cuda.synchronize()
        stated = hasattr(lib, "pbd_dt1d_bwd_strips")
        bad = []
        for case, res, res0 in zip(cases, bufs, first):
            if stated:
                g, h = case[0], case[4]
                lay = tuple(bind(lib, f"pbd_dt1d_bwd_{what}")(h, g.shape[2], g.shape[1])
                            for what in ("strips", "segments"))
                layouts.setdefault(name, []).append(lay)
                want = dt_cuda.dt1d_bwd_order_plain(*case, max(1, lay[0]), lay[1])
                if not all(torch.equal(x, y) for x, y in zip(res, want)):
                    bad.append("dt1d_bwd_order_plain")
                if not all(torch.equal(x, y) for x, y in zip(res, res0)):
                    bad.append("its first run")
            else:
                want = dt_cuda.dt1d_bwd_plain(*case)
                scale = dt_cuda.dt1d_bwd_magnitudes(*case)
                if not all(bool(((x - y).abs() <= 1e-5 * m).all())
                           for x, y, m in zip(res, want, scale)):
                    bad.append("dt1d_bwd_plain (1e-5 x magnitudes)")
        if bad:
            print(f"[dt1d_bwd] {name} differs from {', '.join(bad)}: not timed", flush=True)
            continue
        runs[name] = run
    samples = {}
    for turn in range(3):
        for name, run in runs.items():
            got = samples.setdefault(name, {"device_ms": [], "event_ms": []})
            got["device_ms"].append(device_ms(run, reps=20, launches={"dt1d_bwd": len(cases)}))
            got["event_ms"].append(cuda_ms(run, reps=20))
    times = medians(samples)
    report("dt1d_bwd", times)
    times["layouts"] = layouts
    print(f"[dt1d_bwd] (strips, segments) per pass (y, x): {layouts}", flush=True)
    return times


def run_transpose(torch, cuda_ms, device_ms, libs: dict, old_entry: set) -> dict:
    """Every source at (80, 126, 166), a detect's largest transposes, and
    at (1280, 126, 166), a microbatch of 8's (beyond the L2)."""
    stream = lambda: torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    times = {}
    for maps in (80, 1280):
        gen = torch.Generator().manual_seed(3)
        x = torch.randn((maps, 126, 166), generator=gen).cuda()
        y = torch.randint(0, 4096, (maps, 126, 166), generator=gen,
                          dtype=torch.int32).cuda()
        xt = torch.empty((maps, 166, 126), device="cuda")
        yt = torch.empty((maps, 166, 126), dtype=torch.int32, device="cuda")
        want_x, want_y = (t.transpose(-1, -2).contiguous() for t in (x, y))
        fns = {}
        for name, lib in libs.items():
            if name in old_entry:  # the single-array entry of earlier sources
                fn = bind(lib, "pbd_transpose32", [p, p, i, i, i, p])
                fns[name] = lambda s, d, s1, d1, fn=fn: [
                    kernels.check(fn(a.data_ptr(), b.data_ptr(), maps, 126, 166, stream()),
                                  "transpose launch")
                    for a, b in ((s, d), (s1, d1)) if a is not None]
            else:
                fn = bind(lib, "pbd_transpose32")
                fns[name] = lambda s, d, s1, d1, fn=fn: kernels.check(
                    fn(s.data_ptr(), d.data_ptr(),
                       None if s1 is None else s1.data_ptr(),
                       None if d1 is None else d1.data_ptr(), maps, 126, 166, stream()),
                    "transpose launch")
        for name, fn in fns.items():
            xt.zero_(), yt.zero_()
            fn(x, xt, None, None)
            torch.cuda.synchronize()
            if not torch.equal(xt, want_x):
                raise AssertionError(f"transpose {name}: single differs")
            xt.zero_()
            fn(x, xt, y, yt)
            torch.cuda.synchronize()
            if not (torch.equal(xt, want_x) and torch.equal(yt, want_y)):
                raise AssertionError(f"transpose {name}: pair differs")
        dst = torch.empty_like(x)
        yard = {
            "torch_transpose": lambda: x.transpose(-1, -2).contiguous(),
            "torch_two_transposes": lambda: (x.transpose(-1, -2).contiguous(),
                                             y.transpose(-1, -2).contiguous()),
            "torch_copy": lambda: dst.copy_(x),
        }
        samples = {}

        def keep(key, run, launches=None):
            got = samples.setdefault(f"{key}/{maps}", {"device_ms": [], "event_ms": []})
            got["device_ms"].append(device_ms(
                run, reps=50, launches=None if launches is None else {"transpose": launches}))
            got["event_ms"].append(cuda_ms(run, reps=50))

        for turn in range(3):
            for name, fn in fns.items():
                keep(f"{name}/single", lambda: fn(x, xt, None, None), 1)
                # the single-array entry of earlier sources: a pair is two launches
                keep(f"{name}/pair", lambda: fn(x, xt, y, yt), 2 if name in old_entry else 1)
            for name, run in yard.items():  # torch's copies: no launch counter
                keep(name, run)
        times.update(medians(samples))
        del x, y, xt, yt, dst, want_x, want_y
    report("transpose", times)
    return times


def conv_shapes(torch) -> list:
    """The (features, filters) of each conv call of one person26 VGA
    detect (buckets_per_octave=2, seed-0 frame), captured on the card."""
    from .. import PartsBasedDetector, make_person_like_model
    from .. import pipeline

    calls = []
    orig = pipeline.filter_responses_grouped

    def record(feats, filt, bank=None):
        calls.extend((x.clone(), filt) for x in feats)
        return orig(feats, filt, bank)

    im = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0)).numpy()
    det = PartsBasedDetector(make_person_like_model(), buckets_per_octave=2)
    pipeline.filter_responses_grouped = record
    try:
        det.detect(im)
    finally:
        pipeline.filter_responses_grouped = orig
    return calls


def run_conv(torch, cuda_ms, device_ms, libs: dict, proto_lib, baseline: set) -> dict:
    """Every K2 source at the table shape and over one detect's buckets,
    and T1 at toh 1, 2, 4, 8 on the table shape's features; each held to
    1e-5 * sum|x*w| of filter_responses first."""
    from ..ops.conv import filter_responses
    from ..ops.conv_cuda import split_bank

    stream = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(0)
    feat = torch.rand((5, 130, 170, 32), generator=gen).cuda()
    filt = (0.1 * torch.randn((104, 5, 5, 32), generator=gen)).cuda()
    # all terms positive: partial sums as large as sum|x*w|, where a
    # truncating accumulation errs most
    positive = [(feat, filt.abs())]
    cases = [("table", [(feat, filt)]), ("detect", conv_shapes(torch))]

    def launcher(name, lib, pairs):
        """() -> launch every pair once; outs[i] holds pair i's result."""
        outs, args = [], []
        for x, w in pairs:
            s, h, wd, c = x.shape
            f, fh, fw, _ = w.shape
            if name in baseline:  # the FP32 kernel: K-major weights, F padded to 64
                fp = -(-f // 64) * 64
                wk = torch.zeros((fh * fw * c, fp), device="cuda")
                wk[:, :f] = w.permute(1, 2, 3, 0).reshape(-1, f)
                out = torch.empty((s, h - fh + 1, wd - fw + 1, fp), device="cuda")
                fn = bind(lib, "pbd_conv_fp32", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                          + [ctypes.c_void_p])
                args.append((fn, (x.data_ptr(), wk.data_ptr(), out.data_ptr(),
                                  s, h, wd, c, fh, fw, fp), wk))
                outs.append(out[..., :f])
            else:  # the grouped entry with one stack
                out = torch.empty((s, h - fh + 1, wd - fw + 1, f), device="cuda")
                fn = bind(lib, "pbd_conv_3xtf32_grouped")
                bank = split_bank(w)
                one = lambda *v: (ctypes.c_int * 1)(*v)
                ptrs = [(ctypes.c_void_p * 1)(t.data_ptr()) for t in (x, out)]
                args.append((fn, (*ptrs, one(s), one(h), one(wd), 1, bank.data_ptr(),
                                  c, f, fh, fw), bank))
                outs.append(out)

        def run():
            for fn, a, _ in args:
                kernels.check(fn(*a, stream()), f"conv {name} launch")
        return run, outs

    times, worst = {}, {}
    for name, lib in libs.items():  # the rule on positive terms, reported
        run, outs = launcher(name, lib, positive)
        run()
        want = filter_responses(*positive[0])
        ratio = ((outs[0] - want).abs() / (1e-5 * want)).max().item()
        worst[name] = ratio
        print(f"[conv] {name} positive terms: worst |err| / 1e-5*sum|x*w| = {ratio:.3g}",
              flush=True)
    for case, pairs in cases:
        wants = [filter_responses(x, w) for x, w in pairs]
        scales = [filter_responses(x.abs(), w.abs()) for x, w in pairs]
        runs = {}
        for name, lib in libs.items():
            run, outs = launcher(name, lib, pairs)
            run()
            torch.cuda.synchronize()
            bad = [((o - want).abs() / (1e-5 * sc)).max().item()
                   for o, want, sc in zip(outs, wants, scales)
                   if not bool(((o - want).abs() <= 1e-5 * sc).all())]
            if bad:  # reported and left untimed
                print(f"[conv] {name} ({case}) exceeds 1e-5*sum|x*w| (x{max(bad):.3g}): "
                      "not timed", flush=True)
                continue
            runs[name] = run
        if case == "detect":
            # every bucket in one launch (the pipeline's) against one
            # launch per bucket (the default's entry in turns above)
            lib = libs["conv_default"]
            fn = bind(lib, "pbd_conv_3xtf32_grouped")
            n = len(pairs)
            w = split_bank(pairs[0][1])
            f, fh, fw, c = pairs[0][1].shape
            outs = [torch.empty((x.shape[0], x.shape[1] - fh + 1, x.shape[2] - fw + 1, f),
                                device="cuda") for x, _ in pairs]
            arr = lambda ts: (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
            dims = [(ctypes.c_int * n)(*(x.shape[k] for x, _ in pairs)) for k in range(3)]
            xs, os_ = arr([x for x, _ in pairs]), arr(outs)
            run = lambda: kernels.check(fn(xs, os_, *dims, n, w.data_ptr(), c, f, fh, fw,
                                           stream()), "grouped conv launch")
            run()
            torch.cuda.synchronize()
            ref_run, ref_outs = launcher("conv_default", lib, pairs)
            ref_run()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, ref_outs)):
                raise AssertionError("grouped conv differs from one launch per bucket")
            runs["conv_default_grouped"] = run
        if case == "table":
            x, w = pairs[0]
            xt = x.permute(0, 1, 3, 2).contiguous()
            f = w.shape[0]
            w2 = torch.zeros((800, 128), device="cuda")
            w2[:, :f] = w.permute(1, 2, 3, 0).reshape(-1, f)
            w2 = split_bank(w2)
            run_k2, (k2,) = launcher("conv_default", libs["conv_default"], pairs)
            run_k2()
            fn = bind(proto_lib, "pbd_conv_proto_3xtf32")
            for toh in (1, 2, 4, 8):
                out = torch.empty_like(k2)
                run = (lambda out=out, toh=toh: kernels.check(fn(
                    xt.data_ptr(), w2.data_ptr(), out.data_ptr(), 5, 130, 32, 170,
                    5, 5, f, 128, toh, stream()), "conv_proto launch"))
                run()
                torch.cuda.synchronize()
                if not torch.equal(out, k2):
                    raise AssertionError(f"T1 toh {toh} differs from K2")
                runs[f"conv_proto_toh{toh}"] = run
        samples = {}
        for turn in range(3):
            for name, run in runs.items():
                # launches a call: one grouped, T1 one, else one a pair;
                # the FP32 source of the baseline (conv_fp32_kernel) is
                # in no family of the profiler's and goes unchecked
                n = 1 if name == "conv_default_grouped" or name.startswith("conv_proto") \
                    else len(pairs)
                got = samples.setdefault(f"{name}/{case}", {"device_ms": [], "event_ms": []})
                got["device_ms"].append(device_ms(
                    run, reps=20, launches=None if name in baseline else {"conv": n}))
                got["event_ms"].append(cuda_ms(run, reps=20))
        times.update(medians(samples))
    report("conv", times)
    times["worst_ratio_positive"] = worst
    return times


FAMILIES = ("dt1d", "dt1d_window", "dt1d_bwd", "transpose", "conv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-dir", type=Path, default=None,
                    help="a directory with earlier sources of the families timed "
                         "(dt1d.cu, dt1d_window.cu, dt1d_bwd.cu, transpose.cu, conv.cu)")
    ap.add_argument("--only", default=None,
                    help="comma-separated families to time, of " + ", ".join(FAMILIES)
                         + " (default: all)")
    ap.add_argument("--dt-variants", default=",".join(DT_VARIANTS),
                    help="comma-separated dt1d variants to build (default: all)")
    ap.add_argument("--conv-variants", default=",".join(CONV_VARIANTS),
                    help="comma-separated conv variants to build (default: all)")
    ap.add_argument("--bwd-variants", default=",".join(DT_BWD_VARIANTS),
                    help="comma-separated dt1d_bwd variants to build (default: all)")
    args = ap.parse_args(argv)
    only = FAMILIES if args.only is None else tuple(args.only.split(","))
    unknown = set(only) - set(FAMILIES)
    if unknown:
        ap.error(f"--only: unknown families {sorted(unknown)}")
    import torch

    from ..utils.profiling import cuda_ms, device_ms

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    variants = {
        "dt1d": {k: DT_VARIANTS[k] for k in DT_VARIANTS
                 if k in {"default", *args.dt_variants.split(",")}},
        "dt1d_window": {"default": {}},
        "dt1d_bwd": {k: DT_BWD_VARIANTS[k] for k in DT_BWD_VARIANTS
                     if k in {"default", *args.bwd_variants.split(",")}},
        "transpose": {"default": {}},
        "conv": {k: CONV_VARIANTS[k] for k in CONV_VARIANTS
                 if k in {"default", *args.conv_variants.split(",")}},
    }
    jobs, family = {}, {}
    for stem in only:
        for k, consts in variants[stem].items():
            jobs[f"{stem}_{k}"] = variant_source(kernels.CSRC / f"{stem}.cu", consts)
            family[f"{stem}_{k}"] = stem
        path = None if args.baseline_dir is None else args.baseline_dir / f"{stem}.cu"
        if path is not None and path.exists():
            jobs[f"{stem}_baseline"] = variant_source(path, {})
            family[f"{stem}_baseline"] = stem
    if "conv" in only:
        jobs["proto_default"] = variant_source(kernels.CSRC / "conv_proto.cu", {})
    old = {name for name in jobs if name.endswith("_baseline")}
    libs = build_all(jobs)
    result = {"card": card}
    pick = lambda stem: {k: v for k, v in libs.items() if family.get(k) == stem}
    if "dt1d" in only:
        result["dt1d"] = run_dt(torch, cuda_ms, device_ms, pick("dt1d"))
    if "dt1d_window" in only:
        result["dt1d_window"] = run_window(torch, cuda_ms, device_ms, pick("dt1d_window"))
    if "dt1d_bwd" in only:
        result["dt1d_bwd"] = run_bwd(torch, cuda_ms, device_ms, pick("dt1d_bwd"))
    if "transpose" in only:
        result["transpose"] = run_transpose(
            torch, cuda_ms, device_ms, pick("transpose"), old)
    if "conv" in only:
        torch.backends.cuda.matmul.allow_tf32 = False
        result["conv"] = run_conv(torch, cuda_ms, device_ms, pick("conv"),
                                  libs["proto_default"], old)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
