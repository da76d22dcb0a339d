#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order (each prints one line; any failure raises and the
script exits non-zero without the final line):

  1. device      card name, power limit (nvidia-smi)
  2. build       compile csrc/*.cu with nvcc, build seconds
  3. dt1d        the DT kernel against dt1d_plain on the card: exact
                 values and exact live pointers (y pass, x pass with aux,
                 short nvalid with -inf tails, all-dead maps, integer
                 ties, step 2, the person26 VGA big-bucket shape)
  4. conv        the conv kernel against filter_responses on the card at
                 a person26 VGA bucket, |err| <= 1e-5 * sum|x*w|
  5. golden      tests/fixtures/golden_model.npz through the port on the
                 card: 15 candidates, |dscore| < 2e-3, boxes within 5e-2
  6. person26    the 26-part model at 480x640: K1, K2 and T2 launched,
                 finite scores, identical candidates on two runs, the
                 same candidates as the CPU path at 120x160, and the
                 steady-state ms/image (median after warm-up)
  7. profile     torch.profiler over person26 VGA: device ms per image
                 by kernel family, the busiest kernels, the idle share
     transpose   T2 (the x pass's transposes) against its plain version,
                 bit for bit, f32 and int32 (edge shapes, the person26
                 and Pallas-probe shapes, more than 65,535 maps, every
                 transpose input of one detect and of one microbatch-8
                 program), its gradient; ms and GB/s at (80, 126, 166)
                 beside the plain call and the bound, and one detect's
                 transposes summed
  8. dt1d_bwd    the DT's backward kernel (K4) against dt1d_bwd_plain on
                 the card: g_src within 1e-5 * sum|g| per source, g_a and
                 g_b within 1e-5 * sum|g*d^2| and sum|g*d| per map (y pass,
                 x pass with aux, step 2, integer ties, dead outputs, the
                 person26 240x320 finest-bucket shapes)
  9. train       the SGD training step (train/sgd.py::make_train_step) on
                 person26, batch 8 at 240x320, latent positives: both DT
                 kernels launched, finite loss and pools at every step,
                 the defs projection held, two steps at batch 2, 120x160
                 equal to the CPU path's within rtol 1e-4, atol 1e-5, the
                 median ms/step over 5 steps after a warm-up and images/s,
                 then a torch.profiler pass over one step
 10. dt1d_window the adaptive-window DT (K5) against dt1d_window_plain on
                 the card, bit for bit, and against K1 inside out_valid,
                 (-inf, 0) beyond (y pass, x pass with aux, per-column
                 out_valid with 0 and dlen, all-dead maps, integer ties
                 with and without aux, a == 0 with b == 0 and b != 0, the
                 person26 VGA finest-bucket shapes with the plan's
                 out_valid); ms of K5, K1 and the plain version there
 11. window_detect  person26 at 480x640 with PBD_DT_WINDOW=1: K5 launched,
                 the DT passes that took K5 and K1, candidates bit-identical
                 to the default detect, ms/image medians of both measured
                 in turns, then a torch.profiler pass
 12. fourier     person26 at 480x640 with conv_engine="fourier": finite and
                 deterministic over two runs, the spatial engine's valid
                 mask at thresh=-1e9 with max |dscore| <= 5e-3, ms/image,
                 the spectra's device bytes, the CPU path's candidates at
                 120x160, then a torch.profiler pass
 13. rgbd        the JAX bench's config 5 set-up (person26, thresh=-1e9,
                 16 detections, DepthGate(0.6 m, fx 10, tolerance 0.5),
                 device depth filter, seeded uint16 depth): K1 and K2
                 launched, the CPU path's candidates and keep mask on a
                 120x160 crop, ms/image
 14. serving     the JAX bench's config 4 set-up (64 distinct uint8 VGA
                 frames, person26): detect_many at microbatch 8 launches
                 K1, K2 and T2; its candidates and the pipelined path's
                 (prefetch 6, top 64) equal detect's on 8 frames within
                 1e-5 * max(1, |score|), parts 1e-4; sync ms/image,
                 pipelined and microbatch-8 images/s in turns; device ops
                 and busy ms per image at microbatch 1 and 8 (profiles);
                 the peak device memory at microbatch 8
 15. stream      detect_stream over 12 VGA frames, RGB and (rgb, uint16
                 depth) mixed, gate and device filter on, lookahead 4,
                 2 workers, readback_batch 3: detect's candidates in order
 16. nms         person26 with nms_overlap=0.3: the CPU path's candidates
                 at 120x160, the device keep mask equal to the host
                 part_nms on 8 VGA frames, part_nms_device device ms
                 (profiler) and event ms per image at batch 1 and 8
 17. conv_proto  T1's port on the JAX tool's seeded default inputs at toh
                 1, 2, 4, 8: within 1e-5 * sum|x*w| of its plain version
                 and equal to K2 bit for bit; ms beside K2, conv2d and
                 plain; one run of its harness (python -m
                 partsbaseddetector_tpu_torch.tools.conv_proto)
 18. hybrid      person26 VGA with dtype=bfloat16 (the fp32 re-rank): K1,
                 K2 and T2 launched, deterministic, ms/image beside f32 in
                 turns, the CPU path's candidates at 120x160, the JAX
                 bench's rerank parity at 240x320, the f32 re-rank equal
                 to plain f32, a profile and the re-score stage's share
 19. hybrid_serving  detect_many(microbatch=8) with bf16 over config 4's 64
                 frames: launches, images/s beside f32 in turns, the first
                 8 frames equal to per-frame detect

The second-to-last lines are the kernel table (one JSON object) and the
card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this script, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN_MODEL = ROOT / "tests" / "fixtures" / "golden_model.npz"
GOLDEN_DETS = ROOT / "tests" / "fixtures" / "golden_detections.npz"
CONV_RTOL = 1e-5
DT_BWD_RTOL = 1e-5
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
DEVICE = "cuda"
# the H100 SXM's published peaks at its 700 W limit: HBM3 bytes/s and
# FP32 (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# the port's CUDA-event timer, cuda_ms(fn, reps=5): the mean device ms
# of fn() over reps calls after a warm-up (utils/profiling.py), bound by
# main() once the package imports
cuda_ms = None


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the HBM rate and its operations over the FP32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def dt_work(src, nvalid, dlen, aux=None):
    """Bytes and operations that one pass of the function K1 computes
    needs on these inputs (not what the brute-force kernel spends): the
    generalized DT is O(n) per column by the lower-envelope scan
    (partsbaseddetector_tpu/ops/reference.py::dt1d_envelope), each live
    source entering and leaving the envelope once (~10 FP32 operations,
    the parabola intersection) and each output reading it once (~5);
    src, aux and the per-map parameters are read, values and pointers
    written."""
    bsz, _, w = src.shape
    live = float(nvalid.clamp(0, src.shape[1]).sum())
    ops = (10.0 * live + 5.0 * bsz * dlen) * w
    return nbytes(src, aux) + 16 * bsz + 8 * bsz * dlen * w, ops


def check_dt(torch, dt_cuda, gen) -> dict:
    """The DT kernel against dt1d_plain; returns its timing at the
    person26 VGA big-bucket shape."""
    dev = DEVICE
    errs = []

    def case(name, bsz, h, w, dlen, step=1, aux=False, nv=None, ints=False,
             dead=False):
        if ints:
            src = torch.randint(-4, 5, (bsz, h, w), generator=gen).float()
            a = -torch.randint(1, 3, (bsz,), generator=gen).float()
            b = torch.randint(-2, 3, (bsz,), generator=gen).float()
        else:
            src = torch.randn((bsz, h, w), generator=gen) * 3
            a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
            b = 0.3 * torch.randn((bsz,), generator=gen)
        shift = torch.randint(-3, 4, (bsz,), generator=gen).float()
        if nv is None:
            nvalid = torch.full((bsz,), h, dtype=torch.int32)
        else:
            nvalid = torch.randint(nv[0], nv[1] + 1, (bsz,), generator=gen,
                                   dtype=torch.int32)
            rows = torch.arange(h)[None, :, None]
            src = torch.where(rows < nvalid[:, None, None], src, -torch.inf)
        if dead:
            nvalid[::2] = 0
            src[::2] = -torch.inf
        ax = torch.randint(0, 4096, (bsz, h, w), generator=gen,
                           dtype=torch.int32) if aux else None
        args = [t.to(dev) for t in (src, a, b, shift, nvalid)]
        axd = ax.to(dev) if aux else None
        got_v, got_p = dt_cuda.dt1d(args[0], args[1], args[2], args[3], dlen,
                                    step, nvalid=args[4], aux=axd)
        want_v, want_p = dt_cuda.dt1d_plain(*args, dlen, step, aux=axd)
        torch.cuda.synchronize()
        live = torch.isfinite(want_v)
        err = (got_v - want_v)[live].abs().max().item() if live.any() else 0.0
        errs.append(err)
        if not torch.equal(got_v, want_v):
            raise AssertionError(f"dt1d {name}: values differ (max {err})")
        bad = int((got_p != want_p)[live].sum())
        if bad:
            raise AssertionError(f"dt1d {name}: {bad} live pointers differ")
        return args, axd

    case("ypass", 6, 40, 50, 37, nv=(20, 40))
    case("xpass_aux", 6, 50, 40, 45, aux=True, nv=(10, 50))
    case("dead", 6, 30, 33, 30, aux=True, nv=(0, 30), dead=True)
    case("ties", 8, 24, 40, 24, ints=True)
    case("ties_aux", 8, 24, 40, 24, ints=True, aux=True)
    case("step2", 4, 36, 20, 15, step=2, nv=(18, 36))
    # person26 VGA big bucket: G=4 parts x S=5 scales x M=4 mixtures of
    # 126x166 maps; the y pass, then the x pass with aux
    g_s_m = 4 * 5 * 4
    yargs, _ = case("p26_y", g_s_m, 126, 166, 126, nv=(120, 126))
    xargs, xaux = case("p26_x_aux", g_s_m, 166, 126, 166, aux=True,
                       nv=(160, 166))
    ms_y = cuda_ms(lambda: dt_cuda.dt1d(*yargs[:4], 126, 1, nvalid=yargs[4]))
    ms_x = cuda_ms(lambda: dt_cuda.dt1d(*xargs[:4], 166, 1, nvalid=xargs[4],
                                        aux=xaux))
    plain_y = cuda_ms(lambda: dt_cuda.dt1d_plain(*yargs, 126, 1), reps=3)
    plain_x = cuda_ms(lambda: dt_cuda.dt1d_plain(*xargs, 166, 1, aux=xaux),
                      reps=3)
    ms, plain = ms_y + ms_x, plain_y + plain_x
    work = [dt_work(yargs[0], yargs[4], 126), dt_work(xargs[0], xargs[4], 166, xaux)]
    bnd = bound(sum(w[0] for w in work), sum(w[1] for w in work))
    # the x pass alone: K1 on the transposed map with aux, the K3 port
    xpass = {"max_abs_err": errs[-1], "ms": ms_x, "plain_ms": plain_x,
             **bound(*work[1]), "library_ms": None}
    log("dt1d", cases=len(errs), exact=True, max_abs_err=max(errs),
        shape="y(80,126,166)+x_aux(80,166,126)", ms=f"{ms:.4f}",
        plain_ms=f"{plain:.4f}", bound_ms=f"{bnd['bound_ms']:.4f}",
        bound_by=bnd["bound_by"], library_ms=None, x_pass_ms=f"{ms_x:.4f}",
        x_pass_plain_ms=f"{plain_x:.4f}", x_pass_bound_ms=f"{xpass['bound_ms']:.4f}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain, **bnd,
            "library_ms": None}, xpass


def check_conv(torch, conv, conv_cuda, gen) -> dict:
    """The conv kernel against filter_responses at a person26 VGA bucket
    (plus a bank with zero-padded rows)."""
    dev = DEVICE
    feat = torch.rand((5, 130, 170, 32), generator=gen).to(dev)
    filt = (0.1 * torch.randn((104, 5, 5, 32), generator=gen)).to(dev)
    filt[::3, 3:, :, :] = 0.0  # smaller filters zero-padded in the bank
    got = conv_cuda.filter_responses_infer(feat, filt)
    want = conv.filter_responses(feat, filt)
    scale = conv.filter_responses(feat.abs(), filt.abs())
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"conv shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    ratio = (err / (CONV_RTOL * scale).clamp_min(1e-30)).max().item()
    if not bool((err <= CONV_RTOL * scale).all()):
        raise AssertionError(f"conv error exceeds 1e-5*sum|x*w| (x{ratio:.3g})")
    ms = cuda_ms(lambda: conv_cuda.filter_responses_infer(feat, filt))
    plain = cuda_ms(lambda: conv.filter_responses(feat, filt))
    # the library call: cuDNN's correlation on the same shapes, TF32 off
    x_nchw = feat.permute(0, 3, 1, 2).contiguous()
    w_nchw = filt.permute(0, 3, 1, 2).contiguous()
    conv2d = torch.nn.functional.conv2d
    lib_err = (conv2d(x_nchw, w_nchw).permute(0, 2, 3, 1) - want).abs()
    if not bool((lib_err <= CONV_RTOL * scale).all()):
        raise AssertionError("conv: torch's conv2d disagrees with the plain version")
    library = cuda_ms(lambda: conv2d(x_nchw, w_nchw))
    s_, oh, ow, f_ = want.shape
    k = filt.shape[1] * filt.shape[2] * filt.shape[3]
    bnd = bound(nbytes(feat, filt, want), 2.0 * s_ * oh * ow * k * f_)
    max_err = err.max().item()
    log("conv", shape="(5,130,170,32)x(104,5,5,32)",
        max_abs_err=f"{max_err:.3e}", bound="1e-5*sum|x*w|",
        worst_err_over_bound=f"{ratio:.3g}", ms=f"{ms:.4f}",
        plain_ms=f"{plain:.4f}", library_conv2d_ms=f"{library:.4f}",
        bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"])
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain, **bnd,
            "library_ms": library}


def check_golden(np, pbd) -> None:
    model = pbd.load_model(str(GOLDEN_MODEL))
    g = np.load(GOLDEN_DETS)
    det = pbd.PartsBasedDetector(model, max_detections=64, device=DEVICE)
    got = det.detect(g["image"])
    if len(got) != len(g["scores"]):
        raise AssertionError(f"golden: {len(got)} candidates, want {len(g['scores'])}")
    dscore = max(abs(c.score - s) for c, s in zip(got, g["scores"]))
    dbox = max(float(np.abs(c.parts - b).max()) for c, b in zip(got, g["boxes"]))
    if dscore >= 2e-3 or dbox > 5e-2:
        raise AssertionError(f"golden: dscore {dscore:.3g}, dbox {dbox:.3g}")
    log("golden", candidates=len(got), top_score=f"{got[0].score:.4f}",
        max_dscore=f"{dscore:.3e}", max_dbox=f"{dbox:.3e}")


def same_candidates(a, b, score_tol=0.0, box_tol=0.0) -> bool:
    return len(a) == len(b) and all(
        abs(x.score - y.score) <= score_tol
        and float(abs(x.parts - y.parts).max()) <= box_tol
        and x.component == y.component
        and (x.mixtures == y.mixtures).all()
        for x, y in zip(a, b)
    )


def check_person26(torch, np, pbd, dt_cuda, conv_cuda, tc, gen, card) -> tuple:
    model = pbd.make_person_like_model()
    bpo = 2 if model.interval % 2 == 0 else 1
    im = torch.randint(0, 256, (480, 640, 3), generator=gen,
                       dtype=torch.uint8).numpy()
    det = pbd.PartsBasedDetector(model, buckets_per_octave=bpo, device=DEVICE)
    dt_cuda.launches = dt_cuda.aux_launches = 0
    conv_cuda.launches = 0
    tc.launches = 0
    first = det.detect(im)
    torch.cuda.synchronize()
    counts = {"dt1d": dt_cuda.launches, "dt1d_aux": dt_cuda.aux_launches,
              "conv": conv_cuda.launches, "transpose": tc.launches}
    if min(counts.values()) <= 0:
        raise AssertionError(f"person26: a kernel was not launched: {counts}")
    if not first or not all(np.isfinite(c.score) for c in first):
        raise AssertionError(f"person26: {len(first)} candidates, non-finite or none")
    if not all(np.isfinite(c.parts).all() and c.parts.shape == (26, 4) for c in first):
        raise AssertionError("person26: malformed part boxes")
    second = det.detect(im)
    if not same_candidates(first, second):
        raise AssertionError("person26: two runs differ")
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.detect(im)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)

    small = im[:120, :160]
    det_cpu = pbd.PartsBasedDetector(model, buckets_per_octave=bpo, device="cpu")
    want = det_cpu.detect(small)
    got = det.detect(small)
    if not same_candidates(got, want, score_tol=1e-4, box_tol=1e-3):
        raise AssertionError("person26: CUDA and CPU paths differ at 120x160")
    log("person26", imsize="480x640", buckets_per_octave=bpo,
        candidates=len(first), top_score=f"{first[0].score:.4f}",
        dt1d_launches=counts["dt1d"], dt1d_xpass_launches=counts["dt1d_aux"],
        conv_launches=counts["conv"], transpose_launches=counts["transpose"],
        deterministic=True, cpu_match_120x160=f"{len(want)} candidates",
        ms_per_image_median=f"{ms:.3f}",
        ms_all=",".join(f"{t:.3f}" for t in times), card=f"'{card}'")
    return counts, ms, det, im


# kernel families of a profile, by a piece of the kernel's name (first
# match wins: the window and backward DT names contain the forward's)
FAMILIES = (("dt1d_window", "dt1d_window"), ("dt1d_bwd", "dt1d_axis2_bwd"),
            ("dt1d", "dt1d_axis2"), ("conv", "conv_fp32"),
            ("transpose", "transpose32"), ("fft", "fft"))


def device_profile(torch, prof, per: float = 1.0) -> dict:
    """Device ms of a profiled window by kernel family, divided by `per`
    (images or steps), with the busy total, the device ops and the
    busiest kernels."""
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    kernels = [
        # device-side events only (kernels, copies): the aten ops that
        # launched them carry the same time again
        e for e in prof.key_averages()
        if dev_us(e) and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    families = {k: 0.0 for k, _ in FAMILIES}
    families["other"] = 0.0
    for e in kernels:
        key = next((k for k, name in FAMILIES if name in e.key.lower()), "other")
        families[key] += dev_us(e) / 1e3 / per
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    return {
        "families": families, "busy": sum(families.values()),
        "ops": sum(e.count for e in kernels) / per,
        "top": " | ".join(
            f"{e.key[:48]} {dev_us(e) / 1e3 / per:.3f}ms x{e.count / per:g}"
            for e in top),
    }


def profile_person26(torch, det, im, wall_ms: float, reps: int = 3,
                     phase: str = "profile") -> None:
    """torch.profiler over `reps` person26 VGA detects: device time per
    image by kernel family and for the busiest kernels, and the idle
    share against the unprofiled wall time `wall_ms` (the profiler's own
    host cost inflates the profiled one)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            det.detect(im)
        torch.cuda.synchronize()
    profiled = (time.perf_counter() - t0) * 1e3 / reps
    got = device_profile(torch, prof, reps)
    log(phase, profiled_wall_ms_per_image=f"{profiled:.3f}",
        device_busy_ms_per_image=f"{got['busy']:.3f}",
        idle_share_vs_unprofiled=f"{max(0.0, 1 - got['busy'] / wall_ms):.3f}",
        device_ops_per_image=f"{got['ops']:.0f}",
        **{f"{k}_ms": f"{v:.3f}" for k, v in got["families"].items()},
        top=got["top"])


def check_dt_bwd(torch, dt_cuda, gen) -> dict:
    """K4's backward kernel against dt1d_bwd_plain on the same forward
    outputs; returns its timing at the person26 240x320 finest bucket
    (G=8 parts x S=10 scales x M=4 mixtures of 66x86 maps)."""
    dev = DEVICE
    errs = []

    def case(name, bsz, h, w, dlen, step=1, aux=False, ints=False, dead=False):
        if ints:
            src = torch.randint(-4, 5, (bsz, h, w), generator=gen).float()
            a = -torch.randint(1, 3, (bsz,), generator=gen).float()
            b = torch.randint(-2, 3, (bsz,), generator=gen).float()
            g = torch.randint(-3, 4, (bsz, dlen, w), generator=gen).float()
        else:
            src = torch.randn((bsz, h, w), generator=gen) * 3
            a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
            b = 0.3 * torch.randn((bsz,), generator=gen)
            g = torch.randn((bsz, dlen, w), generator=gen)
        shift = torch.randint(-3, 4, (bsz,), generator=gen).float()
        nvalid = torch.full((bsz,), h, dtype=torch.int32)
        if dead:
            nvalid[::2] = 0
        ax = torch.randint(0, 4096, (bsz, h, w), generator=gen,
                           dtype=torch.int32) if aux else None
        src, a, b, shift, nvalid, g = (
            t.to(dev) for t in (src, a, b, shift, nvalid, g))
        ax = ax.to(dev) if aux else None
        out, ptr = dt_cuda.dt1d(src, a, b, shift, dlen, step, nvalid=nvalid,
                                aux=ax)
        if bool((out == -torch.inf).any()) != dead:
            raise AssertionError(f"dt1d_bwd {name}: dead outputs not as set up")
        args = (g, out, ptr, shift, h, step, aux)
        got = dt_cuda.dt1d_bwd(*args)
        want = dt_cuda.dt1d_bwd_plain(*args)
        bounds = [DT_BWD_RTOL * m for m in dt_cuda.dt1d_bwd_magnitudes(*args)]
        torch.cuda.synchronize()
        for what, x, y, bound in zip(("g_src", "g_a", "g_b"), got, want, bounds):
            if x.shape != y.shape:
                raise AssertionError(f"dt1d_bwd {name}: {what} shape {tuple(x.shape)}")
            err = (x - y).abs()
            if not bool((err <= bound).all()):
                ratio = (err / bound.clamp_min(1e-30)).max().item()
                raise AssertionError(
                    f"dt1d_bwd {name}: {what} exceeds its bound (x{ratio:.3g})")
            errs.append(err.max().item())
        return args

    case("ypass", 7, 40, 50, 37)
    case("xpass_aux", 7, 50, 40, 45, aux=True)
    case("step2", 5, 36, 20, 15, step=2)
    case("ties_aux", 6, 24, 40, 24, aux=True, ints=True)
    case("dead", 6, 30, 33, 30, aux=True, dead=True)
    yargs = case("p26_240x320_y", 8 * 10 * 4, 66, 86, 66)
    xargs = case("p26_240x320_x_aux", 8 * 10 * 4, 86, 66, 86, aux=True)
    ms = cuda_ms(lambda: dt_cuda.dt1d_bwd(*yargs), reps=20)
    ms += cuda_ms(lambda: dt_cuda.dt1d_bwd(*xargs), reps=20)
    plain = cuda_ms(lambda: dt_cuda.dt1d_bwd_plain(*yargs), reps=20)
    plain += cuda_ms(lambda: dt_cuda.dt1d_bwd_plain(*xargs), reps=20)
    # per output: d, g*d, g*d*d and three sums, ~6 FP32 operations; g,
    # out, ptr and shift read, g_src, g_a and g_b written
    moved, ops = 0, 0.0
    for g, _, _, shift, h, _, _ in (yargs, xargs):
        moved += 3 * nbytes(g) + 3 * nbytes(shift) + nbytes(g) // g.shape[1] * h
        ops += 6.0 * g.numel()
    bnd = bound(moved, ops)
    log("dt1d_bwd", cases=7, max_abs_err=f"{max(errs):.3e}",
        bound="1e-5*sum|g| per source, 1e-5*sum|g*d^2|,sum|g*d| per map",
        shape="y(320,66,86)+x_aux(320,86,66)", ms=f"{ms:.4f}",
        plain_ms=f"{plain:.4f}", bound_ms=f"{bnd['bound_ms']:.4f}",
        bound_by=bnd["bound_by"], library_ms=None)
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain, **bnd,
            "library_ms": None}


def train_setup(np, torch, pbd_train, packed, imsize, batch, seed):
    """bench.py config 6's batch: seeded images in [0, 255), labels
    alternating +1/-1, one GT box per image, its latent root masks."""
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(batch, *imsize, 3) * 255.0).astype(np.float32)
    labels = np.array([1.0, -1.0] * (batch // 2), np.float32)
    h, w = imsize
    box = [w / 8, h / 6, w * 7 / 8, h * 5 / 6]  # [40, 40, 280, 200] at 240x320
    masks = pbd_train.batch_root_masks(packed, imsize, np.tile(box, (batch, 1)))
    return imgs, masks, labels


def run_steps(torch, pbd_train, model, packed, imsize, data, device, nsteps):
    """nsteps train steps from the model's own pools on `device`; returns
    (params, losses, seconds per step, each ending in a synchronize)."""
    imgs, masks, labels = data
    step, make_opt = pbd_train.make_train_step(packed, imsize, latent=True)
    loss_fn = pbd_train.make_loss_fn(packed, imsize, latent=True)
    params = pbd_train.model_params(model, device)
    opt = make_opt(params.values())
    imgs_d = torch.as_tensor(imgs, device=device)
    masks_d = [m.to(device) for m in masks]
    losses, secs = [], []
    for _ in range(nsteps):
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, imgs_d, masks_d, labels)
        if device != "cpu":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        bad = [k for k, v in params.items() if not bool(torch.isfinite(v).all())]
        if not math.isfinite(losses[-1]) or bad:
            raise AssertionError(f"train: loss {losses[-1]} or pools {bad} not finite")
        d = params["defs"].detach()
        if bool((d[:, 0] < 0.01).any()) or bool((d[:, 2] < 0.01).any()):
            raise AssertionError("train: the defs projection did not hold")
    return params, losses, secs, (step, loss_fn, params, opt, imgs_d, masks_d, labels)


def check_train(torch, np, pbd, pbd_train, dt_cuda, card) -> dict:
    from partsbaseddetector_tpu_torch.models import pack_model

    model = pbd.make_person_like_model()
    packed = pack_model(model)
    imsize, batch = (240, 320), 8
    data = train_setup(np, torch, pbd_train, packed, imsize, batch, seed=0)
    dt_cuda.launches = 0
    dt_cuda.bwd_launches = 0
    params, losses, secs, ctx = run_steps(
        torch, pbd_train, model, packed, imsize, data, DEVICE, nsteps=6)
    counts = {"dt1d": dt_cuda.launches, "dt1d_bwd": dt_cuda.bwd_launches}
    if min(counts.values()) <= 0:
        raise AssertionError(f"train: a kernel was not launched: {counts}")
    step_ms = statistics.median(secs[1:]) * 1e3
    images_per_s = batch / (step_ms / 1e3)

    # the card against the port's CPU path: two steps, batch 2 at 120x160
    small, small_batch = (120, 160), 2
    sdata = train_setup(np, torch, pbd_train, packed, small, small_batch, seed=1)
    got, glosses, _, _ = run_steps(
        torch, pbd_train, model, packed, small, sdata, DEVICE, nsteps=2)
    want, wlosses, _, _ = run_steps(
        torch, pbd_train, model, packed, small, sdata, "cpu", nsteps=2)
    worst = {}
    for k in want:
        x, y = got[k].detach().cpu(), want[k].detach()
        err = (x - y).abs()
        bound = TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * y.abs()
        worst[k] = (err / bound).max().item()
        if not bool((err <= bound).all()):
            raise AssertionError(f"train: card and CPU pools differ in {k} (x{worst[k]:.3g})")
    dloss = max(abs(a - b) for a, b in zip(glosses, wlosses))
    if dloss > TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * max(map(abs, wlosses)):
        raise AssertionError(f"train: card and CPU losses differ by {dloss:.3g}")

    log("train", model="person26", imsize="240x320", batch=batch, latent=True,
        dt1d_launches=counts["dt1d"], dt1d_bwd_launches=counts["dt1d_bwd"],
        losses=",".join(f"{x:.6f}" for x in losses),
        ms_per_step_median=f"{step_ms:.3f}", images_per_s=f"{images_per_s:.3f}",
        ms_all=",".join(f"{t * 1e3:.3f}" for t in secs),
        cpu_match_120x160="2 steps, batch 2",
        cpu_max_err_over_bound=",".join(f"{k}:{v:.3g}" for k, v in worst.items()),
        cpu_dloss=f"{dloss:.3e}", card=f"'{card}'")
    profile_train_step(torch, ctx, step_ms)
    return {"launches": counts["dt1d_bwd"], "dt1d_launches": counts["dt1d"],
            "step_ms": step_ms, "images_per_s": images_per_s}


def profile_train_step(torch, ctx, wall_ms: float) -> None:
    """torch.profiler over one train step (device busy ms, the idle
    share against the unprofiled median step, the DT kernels' ms), then
    over the forward alone of the same batch, so that the backward's
    share is the difference."""
    from torch.profiler import ProfilerActivity, profile

    step, loss_fn, params, opt, imgs, masks, labels = ctx
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        step(params, opt, imgs, masks, labels)
        torch.cuda.synchronize()
    whole = device_profile(torch, prof)
    with profile(activities=acts) as prof:
        for i, y in enumerate(labels):
            loss_fn.margin_violation(params, imgs[i], float(y), [m[i] for m in masks])
        torch.cuda.synchronize()
    fwd = device_profile(torch, prof)
    log("train_profile", device_busy_ms_per_step=f"{whole['busy']:.3f}",
        idle_share_vs_unprofiled=f"{max(0.0, 1 - whole['busy'] / wall_ms):.3f}",
        device_ops_per_step=f"{whole['ops']:.0f}",
        forward_device_ms=f"{fwd['busy']:.3f}",
        backward_and_update_device_ms=f"{whole['busy'] - fwd['busy']:.3f}",
        forward_ops=f"{fwd['ops']:.0f}",
        **{f"{k}_ms": f"{v:.3f}" for k, v in whole["families"].items()},
        top=whole["top"])


@contextlib.contextmanager
def window_dt(on: bool):
    """PBD_DT_WINDOW set to 1 (on) or 0 for the duration."""
    old = os.environ.get("PBD_DT_WINDOW")
    os.environ["PBD_DT_WINDOW"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PBD_DT_WINDOW", None)
        else:
            os.environ["PBD_DT_WINDOW"] = old


def capture_window_passes(det, im, dtm):
    """One person26 detect with the window DT, recording the arguments
    of every K5 call (ops/distance_transform.py calls dt1d_window once
    for the y pass and once for the x pass of each group); returns the
    (y, x) pair of the group with the largest maps."""
    calls = []
    orig = dtm.dt1d_window

    def record(src, a, b, shift, dlen, out_valid, nvalid=None, aux=None):
        calls.append((src, a, b, shift, nvalid, out_valid, dlen, aux))
        return orig(src, a, b, shift, dlen, out_valid, nvalid=nvalid, aux=aux)

    dtm.dt1d_window = record
    try:
        with window_dt(True):
            det.detect(im)
    finally:
        dtm.dt1d_window = orig
    k = max(range(0, len(calls), 2), key=lambda j: calls[j][0].numel())
    return calls[k], calls[k + 1]


def check_dt_window(torch, dt_cuda, dtm, gen, det, im) -> dict:
    """K5 against dt1d_window_plain (bit for bit, don't-care outputs
    included) and against K1 inside out_valid; returns its timing beside
    K1's and the plain version's at the person26 VGA finest bucket, on
    the DT inputs and consumer extents a real detect gives it."""
    dev = DEVICE

    def flat(src, a, b, shift, nvalid, out_valid, dlen, aux):
        cols = (*src.shape[:-2], src.shape[-1])
        src, a, b, shift, nvalid, aux = dt_cuda.flatten_maps(
            src, a, b, shift, nvalid, aux)
        ov = torch.as_tensor(out_valid, dtype=torch.int32, device=dev)
        ov = ov.broadcast_to(cols).reshape(src.shape[0], cols[-1])
        ov = ov.clamp(0, dlen).contiguous()
        return (src.contiguous(), a, b, shift, nvalid, ov, dlen,
                None if aux is None else aux.contiguous())

    def run(name, src, a, b, shift, nvalid, ov, dlen, aux=None):
        got = dt_cuda.dt1d_window(src, a, b, shift, dlen, ov, nvalid=nvalid, aux=aux)
        want = dt_cuda.dt1d_window_plain(src, a, b, shift, nvalid, ov, dlen, aux)
        k1 = dt_cuda.dt1d(src, a, b, shift, dlen, 1, nvalid=nvalid, aux=aux)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"dt1d_window {name}: differs from its plain version")
        inside = torch.arange(dlen, device=dev)[None, :, None] < ov[:, None, :]
        for x, y, what in ((got[0], k1[0], "values"), (got[1], k1[1], "pointers")):
            if not torch.equal(x[inside], y[inside]):
                raise AssertionError(f"dt1d_window {name}: {what} differ from K1")
        if not (bool((got[0][~inside] == -torch.inf).all())
                and bool((got[1][~inside] == 0).all())):
            raise AssertionError(f"dt1d_window {name}: don't-care outputs not (-inf, 0)")
        return int(inside.sum()), int((~inside).sum())

    def case(name, bsz, h, w, dlen, aux=False, ints=False, dead=False, ab=None):
        if ints:
            src = torch.randint(-4, 5, (bsz, h, w), generator=gen).float()
            a = -torch.randint(1, 3, (bsz,), generator=gen).float()
            b = torch.randint(-2, 3, (bsz,), generator=gen).float()
        else:
            src = torch.randn((bsz, h, w), generator=gen) * 3
            a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
            b = 0.3 * torch.randn((bsz,), generator=gen)
        if ab is not None:
            a.fill_(ab[0])
            b.fill_(ab[1])
        nvalid = torch.randint(h // 2, h + 1, (bsz,), generator=gen, dtype=torch.int32)
        if dead:
            nvalid[::2] = 0
        src = torch.where(torch.arange(h)[None, :, None] < nvalid[:, None, None],
                          src, -torch.inf)
        shift = torch.randint(-3, 4, (bsz,), generator=gen).float()
        ov = torch.randint(0, dlen + 1, (bsz, w), generator=gen, dtype=torch.int32)
        ov[:, 0], ov[:, 1] = 0, dlen  # per-column extents include 0 and dlen
        ax = torch.randint(0, 4096, (bsz, h, w), generator=gen,
                           dtype=torch.int32) if aux else None
        args = [t.to(dev) for t in (src, a, b, shift, nvalid, ov)]
        return run(name, *args, dlen, None if ax is None else ax.to(dev))

    cases = [
        case("ypass", 6, 40, 50, 37),
        case("xpass_aux", 6, 50, 40, 45, aux=True),
        case("dead", 6, 30, 33, 30, aux=True, dead=True),
        case("ties", 8, 24, 40, 24, ints=True),
        case("ties_aux", 8, 24, 40, 24, ints=True, aux=True),
        case("a0_b0", 6, 30, 33, 30, ab=(0.0, 0.0)),
        case("a0_b_nonzero", 6, 30, 33, 30, aux=True, ab=(0.0, 0.5)),
    ]
    ypass, xpass = capture_window_passes(det, im, dtm)
    yargs, xargs = flat(*ypass), flat(*xpass)
    cases.append(run("p26_y", *yargs))
    cases.append(run("p26_x_aux", *xargs))

    def k5():
        dt_cuda.dt1d_window(*yargs[:4], yargs[6], yargs[5], nvalid=yargs[4])
        dt_cuda.dt1d_window(*xargs[:4], xargs[6], xargs[5], nvalid=xargs[4],
                            aux=xargs[7])

    def k1():
        dt_cuda.dt1d(*yargs[:4], yargs[6], 1, nvalid=yargs[4])
        dt_cuda.dt1d(*xargs[:4], xargs[6], 1, nvalid=xargs[4], aux=xargs[7])

    def plain():
        dt_cuda.dt1d_window_plain(*yargs)
        dt_cuda.dt1d_window_plain(*xargs)

    # in turns, as the kernels and the plain version share the card
    ms, k1_ms, plain_ms = [], [], []
    for _ in range(2):
        ms.append(cuda_ms(k5, reps=10))
        k1_ms.append(cuda_ms(k1, reps=10))
        plain_ms.append(cuda_ms(plain, reps=3))
    shape = (f"y{tuple(yargs[0].shape)}+x_aux{tuple(xargs[0].shape)}")
    ms, k1_ms, plain_ms = min(ms), min(k1_ms), min(plain_ms)
    inside = sum(c[0] for c in cases[-2:])
    dont = sum(c[1] for c in cases[-2:])
    # the early exit makes the scan data-dependent and unobservable from
    # here: count the least work, each exact output evaluating at least
    # one source (~5 operations); inputs read, outputs written once
    moved = sum(nbytes(a[0], a[5], a[7]) + 16 * a[0].shape[0]
                + 8 * a[0].shape[0] * a[6] * a[0].shape[2] for a in (yargs, xargs))
    bnd = bound(moved, 5.0 * inside)
    log("dt1d_window", cases=len(cases), exact=True, max_abs_err=0.0,
        shape=shape, p26_outputs_exact=inside, p26_outputs_dont_care=dont,
        ms=f"{ms:.4f}", k1_ms=f"{k1_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
        library_ms=None)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "k1_ms": k1_ms,
            **bnd, "library_ms": None}


def timed_detect(torch, det, im, depth=None) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det.detect(im, depth)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_window_detect(torch, dt_cuda, conv_cuda, det, im, card) -> dict:
    """person26 VGA with PBD_DT_WINDOW=1 against the default detect of
    the same frame: bit-identical candidates, and both ms/image medians
    measured in turns."""
    want = det.detect(im)
    dt_cuda.launches = 0
    dt_cuda.window_launches = 0
    conv_cuda.launches = 0
    with window_dt(True):
        got = det.detect(im)
    torch.cuda.synchronize()
    counts = {"dt1d_window": dt_cuda.window_launches, "dt1d": dt_cuda.launches,
              "conv": conv_cuda.launches}
    if counts["dt1d_window"] <= 0 or counts["conv"] <= 0:
        raise AssertionError(f"window_detect: a kernel was not launched: {counts}")
    if not same_candidates(got, want):
        raise AssertionError("window_detect: candidates differ from the default detect")
    window, default = [], []
    for _ in range(7):
        default.append(timed_detect(torch, det, im))
        with window_dt(True):
            window.append(timed_detect(torch, det, im))
    ms, ms_default = statistics.median(window), statistics.median(default)
    log("window_detect", imsize="x".join(map(str, im.shape[:2])), buckets_per_octave=2,
        candidates=len(got), identical_to_default=True,
        dt_passes_k5=counts["dt1d_window"], dt_passes_k1=counts["dt1d"],
        conv_launches=counts["conv"], ms_per_image_median=f"{ms:.3f}",
        default_ms_per_image_median=f"{ms_default:.3f}",
        ms_all=",".join(f"{t:.3f}" for t in window),
        default_ms_all=",".join(f"{t:.3f}" for t in default), card=f"'{card}'")
    return {"launches": counts["dt1d_window"], "ms": ms}


def dense_equal(np, a, b) -> bool:
    return all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("boxes", "scores", "components", "valid", "mixtures")
    )


def check_fourier(torch, np, pbd, dt_cuda, conv_cuda, im, card) -> tuple:
    """person26 VGA with the Fourier engine, against the spatial engine
    at thresh=-1e9 and against the CPU path at 120x160; returns the
    detector and its ms/image median."""
    model = pbd.make_person_like_model()
    model.thresh = -1e9
    kw = dict(buckets_per_octave=2, device=DEVICE)
    det = pbd.PartsBasedDetector(model, conv_engine="fourier", **kw)
    spatial = pbd.PartsBasedDetector(model, **kw)
    dt_cuda.launches = 0
    conv_cuda.launches = 0
    t0 = time.perf_counter()
    first = det.detect_dense(im)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    counts = {"dt1d": dt_cuda.launches, "conv": conv_cuda.launches}
    if counts["dt1d"] <= 0:
        raise AssertionError(f"fourier: the DT kernel was not launched: {counts}")
    if not np.isfinite(first.scores[first.valid]).all() or not first.valid.any():
        raise AssertionError("fourier: non-finite or no scores")
    if not dense_equal(np, first, det.detect_dense(im)):
        raise AssertionError("fourier: two runs differ")
    want = spatial.detect_dense(im)
    if not np.array_equal(first.valid, want.valid):
        raise AssertionError("fourier: valid mask differs from the spatial engine's")
    dscore = float(np.abs(first.scores - want.scores)[first.valid].max())
    if dscore > 5e-3:
        raise AssertionError(f"fourier: max |dscore| {dscore:.3g} against spatial")
    spectra = det._spectra[tuple(im.shape[:2])]
    nbytes = sum(t.numel() * t.element_size() for t in spectra)
    times, spatial_times = [], []
    for _ in range(7):
        times.append(timed_detect(torch, det, im))
        spatial_times.append(timed_detect(torch, spatial, im))
    small = im[:120, :160]
    cpu = pbd.PartsBasedDetector(model, conv_engine="fourier", device="cpu",
                                 buckets_per_octave=2, max_detections=32)
    card_det = pbd.PartsBasedDetector(model, conv_engine="fourier",
                                      max_detections=32, **kw)
    if not same_candidates(card_det.detect(small), cpu.detect(small),
                           score_tol=1e-4, box_tol=1e-3):
        raise AssertionError("fourier: CUDA and CPU paths differ at 120x160")
    log("fourier", imsize="x".join(map(str, im.shape[:2])), buckets_per_octave=2,
        candidates=int(first.valid.sum()), deterministic=True,
        max_dscore_vs_spatial=f"{dscore:.3e}", bound="5e-3",
        dt1d_launches=counts["dt1d"], conv_launches=counts["conv"],
        first_call_s=f"{setup_s:.3f}", spectra_device_bytes=nbytes,
        ms_per_image_median=f"{statistics.median(times):.3f}",
        spatial_ms_per_image_median=f"{statistics.median(spatial_times):.3f}",
        ms_all=",".join(f"{t:.3f}" for t in times),
        cpu_match_120x160="32 candidates", card=f"'{card}'")
    return det, statistics.median(times)


def check_rgbd(torch, np, pbd, dt_cuda, conv_cuda, im, card) -> None:
    """The JAX package's bench config 5 (bench.py:738-757) on the card:
    both depth stages on the device, a uint16 millimetre frame."""
    from partsbaseddetector_tpu_torch.depth import DepthGate

    model = pbd.make_person_like_model()
    model.thresh = -1e9
    kw = dict(max_detections=16, buckets_per_octave=2, device_depth_filter=True,
              depth_gate=DepthGate(object_width_m=0.6, fx=10.0, tolerance=0.5))
    rng = np.random.RandomState(5)
    depth16 = ((1.0 + rng.rand(*im.shape[:2])) * 1000.0).astype(np.uint16)
    det = pbd.PartsBasedDetector(model, device=DEVICE, **kw)
    dt_cuda.launches = 0
    conv_cuda.launches = 0
    dense = det.detect_dense(im, depth16)
    torch.cuda.synchronize()
    counts = {"dt1d": dt_cuda.launches, "conv": conv_cuda.launches}
    if min(counts.values()) <= 0:
        raise AssertionError(f"rgbd: a kernel was not launched: {counts}")
    if dense.depth_keep is None or not np.isfinite(dense.scores[dense.valid]).all():
        raise AssertionError("rgbd: no keep mask or non-finite scores")
    kept = len(det.detect(im, depth16))
    times = [timed_detect(torch, det, im, depth16) for _ in range(7)]
    small, dsmall = im[:120, :160], depth16[:120, :160]
    cpu = pbd.PartsBasedDetector(model, device="cpu", **kw)
    got, want = det.detect_dense(small, dsmall), cpu.detect_dense(small, dsmall)
    if not np.array_equal(got.depth_keep, want.depth_keep):
        raise AssertionError("rgbd: keep masks differ from the CPU path's at 120x160")
    if not same_candidates(det.detect(small, dsmall), cpu.detect(small, dsmall),
                           score_tol=1e-4, box_tol=1e-3):
        raise AssertionError("rgbd: CUDA and CPU paths differ at 120x160")
    log("rgbd", imsize="x".join(map(str, im.shape[:2])), depth="uint16 mm", candidates=int(dense.valid.sum()),
        kept_by_depth_filter=kept, dt1d_launches=counts["dt1d"],
        conv_launches=counts["conv"],
        ms_per_image_median=f"{statistics.median(times):.3f}",
        ms_all=",".join(f"{t:.3f}" for t in times),
        cpu_match_120x160=f"{int(want.depth_keep.sum())} of {len(want.depth_keep)} kept",
        card=f"'{card}'")


def capture_transposes(run, dtm) -> list:
    """The inputs of every x-pass transpose of run() (the y pass's values
    and pointers, the x pass's values and pointers), recorded through
    ops/distance_transform.py's transpose_last2."""
    calls = []
    orig = dtm.transpose_last2

    def record(x):
        calls.append(x)
        return orig(x)

    dtm.transpose_last2 = record
    try:
        run()
    finally:
        dtm.transpose_last2 = orig
    return calls


def check_transpose(torch, np, tc, dtm, gen, det, im) -> dict:
    """T2 against transpose_last2_plain on the card, bit for bit, f32 and
    int32, at edge shapes, the DT x pass's person26 shapes, the Pallas
    probe's three shapes and more than 65,535 maps, and on every
    transpose input of one person26 VGA detect and of one microbatch-8
    program (maps of 8 images folded together); its gradient; its time
    and the plain call's at (80, 126, 166) f32, and the summed time of
    every transpose of one detect, kernel against plain."""
    dev = DEVICE

    def exact(x, what):
        got, want = tc.transpose_last2(x), tc.transpose_last2_plain(x)
        if got.shape != want.shape or not torch.equal(
                got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"transpose {what}: differs from plain")

    shapes = [(1, 1, 1), (3, 33, 31), (80, 126, 166), (80, 166, 126),
              (160, 168, 128), (160, 166, 126), (520, 128, 104), (70000, 3, 2)]
    for shape in shapes:
        for dtype in (torch.float32, torch.int32):
            if dtype == torch.float32:
                x = torch.randn(shape, generator=gen)
                x.view(-1)[::5] = -torch.inf
            else:
                x = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                  dtype=torch.int32)
            exact(x.to(dev), f"{shape} {dtype}")
    caps = capture_transposes(lambda: det.detect(im), dtm)
    frames = [np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
              for i in range(8)]
    caps8 = capture_transposes(lambda: det.detect_many(frames, microbatch=8), dtm)
    for i, c in enumerate(caps + caps8):
        exact(c, f"captured #{i} {tuple(c.shape)} {c.dtype}")
    if not caps or not caps8:
        raise AssertionError("transpose: a detect ran no x-pass transpose")
    maps = lambda cs: max(c.numel() // (c.shape[-2] * c.shape[-1]) for c in cs)
    n8, most_maps = len(caps8), f"{maps(caps)} detect, {maps(caps8)} microbatch-8"
    del caps8
    x = torch.randn((80, 126, 166), generator=gen).to(dev).requires_grad_()
    cot = torch.randn((80, 166, 126), generator=gen).to(dev)
    (tc.transpose_last2(x) * cot).sum().backward()
    if not torch.equal(x.grad, tc.transpose_last2_plain(cot)):
        raise AssertionError("transpose: the gradient differs from the plain one")

    x = x.detach()
    ms, plain = [], []
    for _ in range(3):  # in turns
        ms.append(cuda_ms(lambda: tc.transpose_last2(x), reps=50))
        plain.append(cuda_ms(lambda: tc.transpose_last2_plain(x), reps=50))
    ms, plain = min(ms), min(plain)
    bnd = bound(2 * nbytes(x), 0.0)
    # one detect's transposes, device time from the profiler (events
    # around 200 launches would time the host's launch loop)
    det_ms = profile_device(
        torch, lambda: [tc.transpose_last2(c) for c in caps], 1)["busy"]
    det_plain = profile_device(
        torch, lambda: [tc.transpose_last2_plain(c) for c in caps], 1)["busy"]
    det_bound = bound(2 * nbytes(*caps), 0.0)["bound_ms"]
    log("transpose", cases=2 * len(shapes), exact=True, gradient_exact=True,
        captured_exact=f"{len(caps)} detect + {n8} microbatch-8",
        most_maps_per_transpose=most_maps,
        shape="(80,126,166) f32", ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
        gb_per_s=f"{2 * nbytes(x) / ms / 1e6:.1f}",
        plain_gb_per_s=f"{2 * nbytes(x) / plain / 1e6:.1f}",
        bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
        per_detect_transposes=len(caps), per_detect_device_ms=f"{det_ms:.4f}",
        per_detect_plain_device_ms=f"{det_plain:.4f}",
        per_detect_bound_ms=f"{det_bound:.4f}")
    # the plain version is the library call: .transpose(-1, -2).contiguous()
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain, **bnd,
            "library_ms": plain}


def close_candidates(a, b) -> bool:
    """The serving tolerance: |dscore| <= 1e-5 * max(1, |score|), parts
    within 1e-4, components and mixtures identical."""
    return len(a) == len(b) and all(
        abs(x.score - y.score) <= 1e-5 * max(1.0, abs(y.score))
        and float(abs(x.parts - y.parts).max()) <= 1e-4
        and x.component == y.component
        and (x.mixtures == y.mixtures).all()
        for x, y in zip(a, b)
    )


def profile_device(torch, run, per: int) -> dict:
    """device_profile of one torch.profiler pass over run(), per `per`
    images."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return device_profile(torch, prof, per)


def check_serving(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card) -> dict:
    """The JAX bench's config 4 set-up (bench.py:654-657): 64 distinct
    uint8 480x640 frames clip(im + i), person26, buckets_per_octave=2,
    f32. The batched program (detect_many, microbatch 8) is this phase's
    main path; then the candidates of the first 8 frames of it and of
    the pipelined path against detect's, timings in turns, one profile
    at microbatch 1 and 8, and the peak device memory at 8."""
    model = pbd.make_person_like_model()
    det = pbd.PartsBasedDetector(model, buckets_per_octave=2, device=DEVICE)
    frames = [np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
              for i in range(64)]
    det.detect_many(frames[:8], microbatch=8)  # warm-up: plans, allocator
    det.detect_many(frames[:8], prefetch=6, readback_top=64)

    # the main path, counts at 0 just before it and read just after;
    # then the other two paths, and the same three again (in turns)
    torch.cuda.reset_peak_memory_stats()
    dt_cuda.launches = conv_cuda.launches = tc.launches = 0
    got8, sec = timed_run(torch, lambda: det.detect_many(frames, microbatch=8))
    counts = {"dt1d": dt_cuda.launches, "conv": conv_cuda.launches,
              "transpose": tc.launches}
    peak = torch.cuda.max_memory_allocated()
    if min(counts.values()) <= 0:
        raise AssertionError(f"serving: a kernel was not launched: {counts}")
    mb8_ips = [64 / sec]
    dt_cuda.launches = conv_cuda.launches = tc.launches = 0
    pipe, sec = timed_run(torch, lambda: det.detect_many(frames, prefetch=6, readback_top=64))
    pipe_counts = (dt_cuda.launches, conv_cuda.launches, tc.launches)
    if min(pipe_counts) <= 0:
        raise AssertionError(f"serving: pipelined path launches {pipe_counts}")
    pipe_ips = [64 / sec]
    want, sec = timed_run(torch, lambda: [det.detect(f) for f in frames[:8]])
    sync_ms = [sec * 1e3 / 8]
    for i, w in enumerate(want):
        if not close_candidates(got8[i], w):
            raise AssertionError(f"serving: microbatch 8 differs from detect, frame {i}")
        if not close_candidates(pipe[i], w[:64]):
            raise AssertionError(f"serving: pipelined path differs from detect, frame {i}")
    if len(got8) != 64 or len(pipe) != 64 or not want[0]:
        raise AssertionError("serving: wrong result count or no candidates")
    sync_ms.append(timed_run(torch, lambda: [det.detect(f) for f in frames[8:16]])[1] * 1e3 / 8)
    pipe_ips.append(64 / timed_run(torch,
        lambda: det.detect_many(frames, prefetch=6, readback_top=64))[1])
    mb8_ips.append(64 / timed_run(torch, lambda: det.detect_many(frames, microbatch=8))[1])
    p1 = profile_device(torch, lambda: det.detect_many(frames[:8]), 8)
    p8 = profile_device(torch, lambda: det.detect_many(frames[:8], microbatch=8), 8)
    log("serving", frames="64 distinct uint8 " + "x".join(map(str, im.shape[:2])),
        buckets_per_octave=2,
        candidates_frame0=len(want[0]), match_first_8="microbatch 8 and pipelined",
        microbatch8_launches=",".join(f"{k}:{v}" for k, v in counts.items()),
        sync_detect_ms_per_image=",".join(f"{t:.3f}" for t in sync_ms),
        pipelined_prefetch6_top64_images_per_s=",".join(f"{t:.3f}" for t in pipe_ips),
        microbatch8_images_per_s=",".join(f"{t:.3f}" for t in mb8_ips),
        mb1_device_ops_per_image=f"{p1['ops']:.0f}",
        mb1_device_busy_ms_per_image=f"{p1['busy']:.3f}",
        mb8_device_ops_per_image=f"{p8['ops']:.0f}",
        mb8_device_busy_ms_per_image=f"{p8['busy']:.3f}",
        mb8_peak_device_bytes=peak, card=f"'{card}'")
    for tag, prof in (("serving_profile_mb1", p1), ("serving_profile_mb8", p8)):
        log(tag, **{f"{k}_ms_per_image": f"{v:.3f}" for k, v in prof["families"].items()},
            top=prof["top"])
    return {"counts": counts}


def check_stream(torch, np, pbd, im, card) -> None:
    """detect_stream on 12 person26 VGA frames, RGB and (rgb, uint16
    depth) pairs mixed, with the depth gate and the device depth filter
    (config 5's set-up), lookahead 4, 2 workers, readback_batch 3: the
    output order and candidates equal per-frame detect's."""
    from partsbaseddetector_tpu_torch.depth import DepthGate

    model = pbd.make_person_like_model()
    model.thresh = -1e9
    det = pbd.PartsBasedDetector(
        model, max_detections=16, buckets_per_octave=2, device=DEVICE,
        device_depth_filter=True,
        depth_gate=DepthGate(object_width_m=0.6, fx=10.0, tolerance=0.5))
    rng = np.random.RandomState(6)
    frames = []
    for i in range(12):
        rgb = np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
        if i % 3 == 2:
            frames.append(rgb)
        else:
            depth = ((1.0 + rng.rand(*im.shape[:2])) * 1000.0).astype(np.uint16)
            frames.append((rgb, depth))
    args = lambda f: f if isinstance(f, tuple) else (f,)
    det.detect(*args(frames[0]))  # warm-up
    t0 = time.perf_counter()
    want = [det.detect(*args(f)) for f in frames]
    sync_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    got = list(det.detect_stream(frames, lookahead=4, workers=2, readback_batch=3))
    stream_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    if len(got) != len(want) or not all(
            same_candidates(g, w) for g, w in zip(got, want)):
        raise AssertionError("stream: order or candidates differ from detect")
    log("stream", frames="12 uint8 " + "x".join(map(str, im.shape[:2]))
        + ", 8 with uint16 depth", readback_batch=3,
        workers=2, lookahead=4, identical_to_detect=True,
        candidates=",".join(str(len(g)) for g in got),
        stream_ms_per_frame=f"{stream_ms:.3f}", detect_ms_per_frame=f"{sync_ms:.3f}",
        card=f"'{card}'")


def check_nms(torch, np, pbd, nms, im, card) -> None:
    """person26 with nms_overlap=0.3: the CPU path's candidates at
    120x160, and the device time (profiler) and event time of
    part_nms_device per image at batch 1 and 8 on the top-k of VGA
    detects."""
    model = pbd.make_person_like_model()
    model.thresh = -1e9
    kw = dict(buckets_per_octave=2, nms_overlap=0.3)
    det = pbd.PartsBasedDetector(model, device=DEVICE, **kw)
    small = im[:120, :160]
    got = det.detect(small)
    want = pbd.PartsBasedDetector(model, device="cpu", **kw).detect(small)
    plain = pbd.PartsBasedDetector(model, device=DEVICE, buckets_per_octave=2)
    if not 0 < len(got) < len(plain.detect(small)):
        raise AssertionError("nms: suppressed nothing or everything")
    if not same_candidates(got, want, score_tol=1e-4, box_tol=1e-3):
        raise AssertionError("nms: CUDA and CPU paths differ at 120x160")
    frames = np.stack([np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
                       for i in range(8)])
    boxes, scores, _, valid, _ = plain.detect_batch_fn(im.shape[:2], 8)(
        torch.as_tensor(frames, device=DEVICE))
    per_image, busy = {}, {}
    for b in (1, 8):
        args = (boxes[:b], scores[:b], valid[:b], 0.3)
        per_image[b] = cuda_ms(lambda: nms.part_nms_device(*args), reps=5) / b
        busy[b] = profile_device(torch, lambda: nms.part_nms_device(*args), b)

    keep = nms.part_nms_device(boxes, scores, valid, 0.3)
    for i in range(8):
        live = np.flatnonzero(valid[i].cpu().numpy())
        host = live[nms.part_nms(boxes[i].cpu().numpy()[live],
                                 scores[i].cpu().numpy()[live], 0.3)]
        if not np.array_equal(np.sort(host), np.flatnonzero(keep[i].cpu().numpy())):
            raise AssertionError(f"nms: device keep mask differs from part_nms, frame {i}")
    log("nms", overlap=0.3, candidates_120x160=f"{len(got)} of {len(plain.detect(small))}",
        cpu_match_120x160=True, host_part_nms_match="8 VGA frames",
        kept_vga=",".join(str(int(k.sum())) for k in keep),
        # device time from the profiler; CUDA events around the call also
        # count the N-step chain's launch gaps
        device_ms_per_image_batch1=f"{busy[1]['busy']:.4f}",
        device_ms_per_image_batch8=f"{busy[8]['busy']:.4f}",
        device_ops_per_image_batch1=f"{busy[1]['ops']:.0f}",
        device_ops_per_image_batch8=f"{busy[8]['ops']:.0f}",
        event_ms_per_image_batch1=f"{per_image[1]:.4f}",
        event_ms_per_image_batch8=f"{per_image[8]:.4f}", card=f"'{card}'")


def timed_run(torch, run):
    """(run()'s result, seconds), ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_conv_proto(torch, cp, conv_cuda, harness) -> dict:
    """T1's port on the JAX tool's seeded default inputs (RandomState(0),
    (5, 126, 166, 32) x (104, 5, 5, 32)) at toh 1, 2, 4 and 8: within
    1e-5 * sum|x*w| of its plain version and equal to K2 bit for bit
    (both sum in (i, j, c) order with fmaf); ms at each toh beside K2,
    conv2d and the plain version, in turns; then one run of the harness
    itself, `python -m partsbaseddetector_tpu_torch.tools.conv_proto`,
    whose launch count is the row's."""
    dev = DEVICE
    s, f, h, w = 5, 104, 126, 166
    feat_np, filt_np = harness.seeded_inputs(s, h, w, f)
    feat = torch.as_tensor(feat_np, device=dev)
    filt = torch.as_tensor(filt_np, device=dev)
    feat_t = feat.permute(0, 1, 3, 2).contiguous()
    w2 = cp.weights_k_major(filt)
    want = cp.conv_proto_plain(feat_t, w2, f)
    scale = cp.conv_proto_plain(feat_t.abs(), w2.abs(), f)
    k2 = conv_cuda.filter_responses_infer(feat, filt)
    tohs = (1, 2, 4, 8)
    errs = {}
    for toh in tohs:
        got = cp.conv_proto(feat_t, w2, f, toh)
        torch.cuda.synchronize()
        err = (got - want).abs()
        if got.shape != want.shape or not bool((err <= CONV_RTOL * scale).all()):
            raise AssertionError(f"conv_proto toh={toh}: exceeds 1e-5*sum|x*w|")
        if not torch.equal(got, k2):
            raise AssertionError(f"conv_proto toh={toh}: differs from K2")
        errs[toh] = err.max().item()
    x_nchw = feat.permute(0, 3, 1, 2).contiguous()
    w_nchw = filt.permute(0, 3, 1, 2).contiguous()
    conv2d = torch.nn.functional.conv2d
    ms = {t: [] for t in tohs}
    k2_ms, lib_ms, plain_ms = [], [], []
    for _ in range(2):  # in turns
        for t in tohs:
            ms[t].append(cuda_ms(lambda t=t: cp.conv_proto(feat_t, w2, f, t), reps=20))
        k2_ms.append(cuda_ms(lambda: conv_cuda.filter_responses_infer(feat, filt), reps=20))
        lib_ms.append(cuda_ms(lambda: conv2d(x_nchw, w_nchw), reps=20))
        plain_ms.append(cuda_ms(lambda: cp.conv_proto_plain(feat_t, w2, f), reps=5))
    ms = {t: min(v) for t, v in ms.items()}
    k2_ms, lib_ms, plain_ms = min(k2_ms), min(lib_ms), min(plain_ms)
    _, oh, ow, _ = want.shape
    ops = 2.0 * s * oh * ow * cp.FH * cp.FW * cp.C * f
    bnd = bound(nbytes(feat_t, w2, want), ops)

    proc = subprocess.run(
        [sys.executable, "-m", "partsbaseddetector_tpu_torch.tools.conv_proto"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise AssertionError(f"conv_proto harness failed:\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if not res.get("equal_to_k2") or res.get("launches") != 1:
        raise AssertionError(f"conv_proto harness: {res}")
    tflops = lambda t: ops / t / 1e9
    log("conv_proto", shape="(5,126,166,32)x(104,5,5,32)", seed="RandomState(0)",
        equal_to_k2="bit for bit at toh 1,2,4,8",
        max_abs_err=",".join(f"{t}:{e:.3e}" for t, e in errs.items()),
        bound="1e-5*sum|x*w|",
        ms_by_toh=",".join(f"{t}:{v:.4f}" for t, v in ms.items()),
        tflops_by_toh=",".join(f"{t}:{tflops(v):.2f}" for t, v in ms.items()),
        k2_ms=f"{k2_ms:.4f}", library_conv2d_ms=f"{lib_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bnd['bound_ms']:.4f}",
        bound_by=bnd["bound_by"], gflop=f"{ops / 1e9:.3f}",
        harness=f"rc 0, toh 2 {res['ms']:.4f} ms, K2 {res['k2_ms']:.4f} ms, "
                f"conv2d {res['conv2d_ms']:.4f} ms")
    return {"launches": res["launches"], "max_abs_err": max(errs.values()),
            "ms": ms[2], "ms_by_toh": ms, "k2_ms": k2_ms, "plain_ms": plain_ms,
            **bnd, "library_ms": lib_ms}


def match_boxes(bx_ref, sc_ref, vd_ref, bx, sc, vd, tol_px=0.75):
    """bench.py::_match_boxes: greedily match each valid candidate to an
    unused valid reference candidate whose part boxes all lie within
    tol_px; returns (candidates, matched, max |score delta| of the
    matches)."""
    import numpy as np

    qi, ri = np.flatnonzero(vd), np.flatnonzero(vd_ref)
    if len(qi) == 0 or len(ri) == 0:
        return len(qi), 0, float("nan")
    matched, dmax = 0, 0.0
    used = np.zeros(len(ri), bool)
    for q in qi:
        d = np.abs(bx_ref[ri] - bx[q][None]).max(axis=(1, 2))
        d = np.where(used, np.inf, d)
        j = int(np.argmin(d))
        if d[j] <= tol_px:
            used[j] = True
            matched += 1
            dmax = max(dmax, float(abs(sc_ref[ri[j]] - sc[q])))
    return len(qi), matched, dmax


def check_hybrid(torch, np, pbd, dt_cuda, conv_cuda, tc, det, im, card) -> dict:
    """The hybrid profile (dtype=bfloat16, the fp32 re-rank on) on
    person26 VGA, buckets_per_octave=2: K1, K2 and T2 launched by one
    detect; two runs identical; ms/image beside the f32 detector `det`,
    in turns, medians of 7; the CPU path's candidates at 120x160
    (thresh -1e9, 32 detections) within 1e-5 * max(1, |score|), parts
    1e-4; the JAX bench's rerank parity at 240x320 (bench.py:481-531:
    thresh -1e9, 16 detections, the top-1 boxes within 0.75 px and its
    score within 1e-3 of f32, at least 80% of the candidates
    box-matched); rerank_fp32=True at f32 equal to plain f32 (scores
    2e-5, parts 1e-4); a profile, and the re-score stage's device time
    alone on the inputs a detect gave it."""
    import partsbaseddetector_tpu_torch.detector as detector_mod

    bf16 = torch.bfloat16
    model = pbd.make_person_like_model()
    hdet = pbd.PartsBasedDetector(model, buckets_per_octave=2, dtype=bf16,
                                  device=DEVICE)
    hdet.detect(im)  # warm-up: plan, re-score tables
    dt_cuda.launches = dt_cuda.aux_launches = conv_cuda.launches = tc.launches = 0
    first = hdet.detect(im)
    torch.cuda.synchronize()
    counts = {"dt1d": dt_cuda.launches, "dt1d_aux": dt_cuda.aux_launches,
              "conv": conv_cuda.launches, "transpose": tc.launches}
    if min(counts.values()) <= 0:
        raise AssertionError(f"hybrid: a kernel was not launched: {counts}")
    if not first or not all(np.isfinite(c.score) and np.isfinite(c.parts).all()
                            and c.parts.shape == (26, 4) for c in first):
        raise AssertionError("hybrid: no candidates, or malformed ones")
    if not same_candidates(first, hdet.detect(im)):
        raise AssertionError("hybrid: two runs differ")
    hy, f32 = [], []
    for _ in range(7):
        f32.append(timed_detect(torch, det, im))
        hy.append(timed_detect(torch, hdet, im))

    lo = pbd.make_person_like_model()
    lo.thresh = -1e9
    small = im[:120, :160]
    kw = dict(max_detections=32, buckets_per_octave=2, dtype=bf16)
    got = pbd.PartsBasedDetector(lo, device=DEVICE, **kw).detect(small)
    want = pbd.PartsBasedDetector(lo, device="cpu", **kw).detect(small)
    if not got or not close_candidates(got, want):
        raise AssertionError("hybrid: CUDA and CPU paths differ at 120x160")
    cpu_dscore = max(abs(x.score - y.score) for x, y in zip(got, want))

    mid = im[:240, :320]
    kwp = dict(max_detections=16, buckets_per_octave=2, device=DEVICE)
    o32 = pbd.PartsBasedDetector(lo, **kwp).detect_dense(mid)
    ohy = pbd.PartsBasedDetector(lo, dtype=bf16, **kwp).detect_dense(mid)
    nq, nm, dmax = match_boxes(o32.boxes, o32.scores, o32.valid,
                               ohy.boxes, ohy.scores, ohy.valid)
    top1 = bool(o32.valid[0] and ohy.valid[0]
                and np.abs(o32.boxes[0] - ohy.boxes[0]).max() <= 0.75
                and abs(float(o32.scores[0]) - float(ohy.scores[0])) <= 1e-3)
    if not (top1 and nm >= max(1, int(0.8 * nq))):
        raise AssertionError(f"hybrid: rerank parity failed (top1 {top1}, {nm}/{nq})")
    plain32 = pbd.PartsBasedDetector(lo, **kwp).detect(mid)
    rr32 = pbd.PartsBasedDetector(lo, rerank_fp32=True, **kwp).detect(mid)
    if not same_candidates(rr32, plain32, score_tol=2e-5, box_tol=1e-4):
        raise AssertionError("hybrid: the f32 re-rank differs from plain f32")
    rr_dscore = max(abs(x.score - y.score) for x, y in zip(rr32, plain32))

    prof = profile_device(torch, lambda: [hdet.detect(im) for _ in range(3)], 3)
    calls = []
    orig = detector_mod.rescore_from_responses

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    detector_mod.rescore_from_responses = record
    try:
        hdet.detect(im)
    finally:
        detector_mod.rescore_from_responses = orig
    args, kwargs = calls[0]
    stage = profile_device(torch, lambda: orig(*args, **kwargs), 1)
    del calls, args, kwargs
    ms, ms32 = statistics.median(hy), statistics.median(f32)
    log("hybrid", imsize="x".join(map(str, im.shape[:2])), buckets_per_octave=2,
        dtype="bfloat16", rerank_fp32=True, candidates=len(first),
        top_score=f"{first[0].score:.4f}", deterministic=True,
        dt1d_launches=counts["dt1d"], dt1d_xpass_launches=counts["dt1d_aux"],
        conv_launches=counts["conv"], transpose_launches=counts["transpose"],
        ms_per_image_median=f"{ms:.3f}", f32_ms_per_image_median=f"{ms32:.3f}",
        ms_all=",".join(f"{t:.3f}" for t in hy),
        f32_ms_all=",".join(f"{t:.3f}" for t in f32),
        cpu_match_120x160=f"{len(want)} candidates, max dscore {cpu_dscore:.3e}",
        rerank_parity_240x320=f"top1 {top1}, matched {nm}/{nq}, max dscore {dmax:.3e}",
        f32_rerank_identity_240x320=f"max dscore {rr_dscore:.3e}",
        device_busy_ms_per_image=f"{prof['busy']:.3f}",
        device_ops_per_image=f"{prof['ops']:.0f}",
        idle_share_vs_unprofiled=f"{max(0.0, 1 - prof['busy'] / ms):.3f}",
        rescore_device_ms=f"{stage['busy']:.4f}",
        rescore_device_ops=f"{stage['ops']:.0f}",
        rescore_share_of_busy=f"{stage['busy'] / prof['busy']:.4f}",
        card=f"'{card}'")
    log("hybrid_profile", **{f"{k}_ms": f"{v:.3f}" for k, v in prof["families"].items()},
        top=prof["top"])
    return {"counts": counts, "ms": ms}


def check_hybrid_serving(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card) -> None:
    """detect_many(microbatch=8) with the hybrid profile over config 4's
    64 VGA frames (the main path, counts at 0 just before it), images/s
    beside the f32 detector's in turns, and the batched candidates of
    the first 8 frames equal to per-frame bf16 detect's within
    1e-5 * max(1, |score|), parts 1e-4."""
    model = pbd.make_person_like_model()
    frames = [np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
              for i in range(64)]
    hy = pbd.PartsBasedDetector(model, buckets_per_octave=2, dtype=torch.bfloat16,
                                device=DEVICE)
    f32 = pbd.PartsBasedDetector(model, buckets_per_octave=2, device=DEVICE)
    hy.detect_many(frames[:8], microbatch=8)  # warm-up: plans, allocator
    f32.detect_many(frames[:8], microbatch=8)
    torch.cuda.reset_peak_memory_stats()
    dt_cuda.launches = conv_cuda.launches = tc.launches = 0
    got8, sec = timed_run(torch, lambda: hy.detect_many(frames, microbatch=8))
    counts = {"dt1d": dt_cuda.launches, "conv": conv_cuda.launches,
              "transpose": tc.launches}
    peak = torch.cuda.max_memory_allocated()
    if min(counts.values()) <= 0:
        raise AssertionError(f"hybrid_serving: a kernel was not launched: {counts}")
    hy_ips, f32_ips = [64 / sec], []
    for _ in range(2):
        f32_ips.append(64 / timed_run(torch, lambda: f32.detect_many(frames, microbatch=8))[1])
    hy_ips.append(64 / timed_run(torch, lambda: hy.detect_many(frames, microbatch=8))[1])
    want = [hy.detect(f) for f in frames[:8]]
    if len(got8) != 64 or not want[0]:
        raise AssertionError("hybrid_serving: wrong result count or no candidates")
    for i, w in enumerate(want):
        if not close_candidates(got8[i], w):
            raise AssertionError(f"hybrid_serving: microbatch 8 differs from detect, frame {i}")
    log("hybrid_serving", frames="64 distinct uint8 " + "x".join(map(str, im.shape[:2])),
        buckets_per_octave=2, dtype="bfloat16", match_first_8=True,
        microbatch8_launches=",".join(f"{k}:{v}" for k, v in counts.items()),
        microbatch8_images_per_s=",".join(f"{t:.3f}" for t in hy_ips),
        f32_microbatch8_images_per_s=",".join(f"{t:.3f}" for t in f32_ips),
        mb8_peak_device_bytes=peak, card=f"'{card}'")


def main() -> int:
    global cuda_ms
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import numpy as np

        import partsbaseddetector_tpu_torch as pbd
        import partsbaseddetector_tpu_torch.train as pbd_train
        from partsbaseddetector_tpu_torch import kernels
        from partsbaseddetector_tpu_torch.ops import conv, conv_cuda, dt_cuda, nms
        from partsbaseddetector_tpu_torch.ops import conv_proto_cuda as cp
        from partsbaseddetector_tpu_torch.tools import conv_proto as harness
        from partsbaseddetector_tpu_torch.ops import distance_transform as dtm
        from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc
        from partsbaseddetector_tpu_torch.utils.profiling import cuda_ms
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log("device", name=f"'{name}'", nvidia_smi=f"'{card}'",
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    build_s = time.perf_counter() - t0
    regs = [
        line.strip() for line in lib_path.with_suffix(".log").read_text().splitlines()
        if "registers" in line
    ]
    log("build", seconds=f"{build_s:.2f}", library=lib_path.name,
        ptxas=" | ".join(regs))

    gen = torch.Generator().manual_seed(0)
    dt_row, xpass_row = check_dt(torch, dt_cuda, gen)
    conv_row = check_conv(torch, conv, conv_cuda, gen)
    check_golden(np, pbd)
    counts, ms, det, im = check_person26(
        torch, np, pbd, dt_cuda, conv_cuda, tc, gen, card
    )
    profile_person26(torch, det, im, ms)
    tp_row = check_transpose(torch, np, tc, dtm, gen, det, im)
    bwd_row = check_dt_bwd(torch, dt_cuda, gen)
    train = check_train(torch, np, pbd, pbd_train, dt_cuda, card)
    win_row = check_dt_window(torch, dt_cuda, dtm, gen, det, im)
    win = check_window_detect(torch, dt_cuda, conv_cuda, det, im, card)
    with window_dt(True):
        profile_person26(torch, det, im, win["ms"], phase="window_profile")
    det_f, ms_f = check_fourier(torch, np, pbd, dt_cuda, conv_cuda, im, card)
    profile_person26(torch, det_f, im, ms_f, phase="fourier_profile")
    check_rgbd(torch, np, pbd, dt_cuda, conv_cuda, im, card)
    serving = check_serving(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card)
    check_stream(torch, np, pbd, im, card)
    check_nms(torch, np, pbd, nms, im, card)
    t1_row = check_conv_proto(torch, cp, conv_cuda, harness)
    hybrid = check_hybrid(torch, np, pbd, dt_cuda, conv_cuda, tc, det, im, card)
    check_hybrid_serving(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card)
    hyb = hybrid["counts"]

    table = {"kernels": [
        {"name": "dt1d_axis2", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d.cu",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:518",
         "also_replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:75",
         "launches": counts["dt1d"], "hybrid_launches": hyb["dt1d"], **dt_row},
        # K3's row: the same kernel's x passes (the transposed map, aux),
        # counted where they launch
        {"name": "dt1d_axis2_xpass", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d.cu",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:75",
         "launches": counts["dt1d_aux"], "hybrid_launches": hyb["dt1d_aux"],
         **xpass_row},
        {"name": "conv_fp32", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/conv.cu",
         "replaces": "partsbaseddetector_tpu/ops/conv_pallas.py:101",
         "launches": counts["conv"], "hybrid_launches": hyb["conv"], **conv_row},
        {"name": "dt1d_axis2_bwd", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d_bwd.cu",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:809",
         "launches": train["launches"], **bwd_row},
        {"name": "dt1d_window_axis2", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d_window.cu",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:321",
         "launches": win["launches"], **win_row},
        {"name": "transpose32", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/transpose.cu",
         "replaces": "tools/transpose_kernel_probe.py:25",
         "launches": serving["counts"]["transpose"],
         "hybrid_launches": hyb["transpose"], **tp_row},
        {"name": "conv_proto_fp32", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/conv_proto.cu",
         "replaces": "tools/conv_pallas_proto.py:62",
         "pallas_call": "tools/conv_pallas_proto.py:88", **t1_row},
    ]}
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
