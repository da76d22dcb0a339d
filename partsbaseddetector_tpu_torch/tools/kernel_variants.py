"""Time the DT kernel (K1), its variants and the transpose (T2) on the card.

A variant is `csrc/dt1d.cu` with some of its `constexpr` tuning constants
replaced; the transpose has none and is timed as it is. With
`--baseline-dir`, an earlier `dt1d.cu` and `transpose.cu` are timed
beside them: a redesign's before and after on the same inputs in one
process. Each source is compiled on its own (one `nvcc` each, all started
together), loaded with `ctypes`, held against the kernel's plain version
bit for bit and timed by direct launches, all in turns, so that their
times compare: K1 with CUDA events, T2 (faster than the host launches
it) by the profiler's device time with the event time beside it:

    python -m partsbaseddetector_tpu_torch.tools.kernel_variants
    python -m partsbaseddetector_tpu_torch.tools.kernel_variants \\
        --baseline-dir old_csrc   # also time an earlier dt1d.cu / transpose.cu

Shapes: K1 at the person26 VGA finest bucket, y (80, 126, 166) then x with
aux (80, 166, 126), on random maps (N(0, 9) sources, a in [-0.06, -0.01])
and on spiky maps (responses near -1 with a few peaks, a = -0.01); T2 at
(80, 126, 166) and (1280, 126, 166), a single f32 array and an (f32,
i32) pair, beside torch's transposed copy and a contiguous copy of the
same bytes. The last line of the output is one JSON object with every
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


def variant_source(path: Path, consts: dict) -> str:
    text = path.read_text()
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
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        used = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {name}: " + " | ".join(used), flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bind(lib, entry: str, args=None):
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = kernels._SIGNATURES[entry]
    if args is not None:
        fn.argtypes = args
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


def run_dt(torch, cuda_ms, libs: dict) -> dict:
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
        for turn in range(2):
            for name, fn in fns.items():
                ms = [cuda_ms(lambda: call(fn, p, *buf), reps=20)
                      for p, buf in zip(passes, bufs)]
                key = f"{name}/{kind}"
                best = times.get(key)
                if best is None or sum(ms) < best["ms"]:
                    times[key] = {"ms": sum(ms), "y_ms": ms[0], "x_ms": ms[1]}
    for key, t in times.items():
        print(f"[dt1d] {key} ms={t['ms']:.4f} y={t['y_ms']:.4f} x={t['x_ms']:.4f}",
              flush=True)
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

        def keep(key, run):
            got = samples.setdefault(f"{key}/{maps}", {"device_ms": [], "event_ms": []})
            got["device_ms"].append(device_ms(run, reps=50))
            got["event_ms"].append(cuda_ms(run, reps=50))

        for turn in range(3):
            for name, fn in fns.items():
                keep(f"{name}/single", lambda: fn(x, xt, None, None))
                keep(f"{name}/pair", lambda: fn(x, xt, y, yt))
            for name, run in yard.items():
                keep(name, run)
        # medians of the three turns: the profiler now and then loses events
        times.update({key: {k: statistics.median(v) for k, v in got.items()}
                      for key, got in samples.items()})
        del x, y, xt, yt, dst, want_x, want_y
    for key, t in times.items():
        print(f"[transpose] {key} device_ms={t['device_ms']:.4f} "
              f"event_ms={t['event_ms']:.4f}", flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-dir", type=Path, default=None,
                    help="a directory with an earlier dt1d.cu and transpose.cu")
    args = ap.parse_args(argv)
    import torch

    from ..utils.profiling import cuda_ms, device_ms

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    jobs = {f"dt1d_{k}": variant_source(kernels.CSRC / "dt1d.cu", v)
            for k, v in DT_VARIANTS.items()}
    jobs["transpose_default"] = (kernels.CSRC / "transpose.cu").read_text()
    old = set()
    if args.baseline_dir is not None:
        for stem in ("dt1d", "transpose"):
            path = args.baseline_dir / f"{stem}.cu"
            if path.exists():
                jobs[f"{stem}_baseline"] = path.read_text()
                old.add(f"{stem}_baseline")
    libs = build_all(jobs)
    result = {"card": card}
    pick = lambda stem: {k: v for k, v in libs.items() if k.startswith(stem + "_")}
    result["dt1d"] = run_dt(torch, cuda_ms, pick("dt1d"))
    result["transpose"] = run_transpose(
        torch, cuda_ms, device_ms, pick("transpose"), old)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
