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
  6. person26    the 26-part model at 480x640: both kernels launched,
                 finite scores, identical candidates on two runs, the
                 same candidates as the CPU path at 120x160, and the
                 steady-state ms/image (median after warm-up)
  7. profile     torch.profiler over person26 VGA: device ms per image
                 by kernel family, the busiest kernels, the idle share
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

The second-to-last lines are the kernel table (one JSON object) and the
card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this script, it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
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


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
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
    ms = cuda_ms(lambda: dt_cuda.dt1d(*yargs[:4], 126, 1, nvalid=yargs[4]))
    ms += cuda_ms(lambda: dt_cuda.dt1d(*xargs[:4], 166, 1, nvalid=xargs[4],
                                       aux=xaux))
    plain = cuda_ms(lambda: dt_cuda.dt1d_plain(*yargs, 126, 1), reps=3)
    plain += cuda_ms(lambda: dt_cuda.dt1d_plain(*xargs, 166, 1, aux=xaux),
                     reps=3)
    log("dt1d", cases=len(errs), exact=True, max_abs_err=max(errs),
        shape="y(80,126,166)+x_aux(80,166,126)", ms=f"{ms:.4f}",
        plain_ms=f"{plain:.4f}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain}


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
    max_err = err.max().item()
    log("conv", shape="(5,130,170,32)x(104,5,5,32)",
        max_abs_err=f"{max_err:.3e}", bound="1e-5*sum|x*w|",
        worst_err_over_bound=f"{ratio:.3g}", ms=f"{ms:.4f}",
        plain_ms=f"{plain:.4f}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain}


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


def check_person26(torch, np, pbd, dt_cuda, conv_cuda, gen, card) -> tuple:
    model = pbd.make_person_like_model()
    bpo = 2 if model.interval % 2 == 0 else 1
    im = torch.randint(0, 256, (480, 640, 3), generator=gen,
                       dtype=torch.uint8).numpy()
    det = pbd.PartsBasedDetector(model, buckets_per_octave=bpo, device=DEVICE)
    dt_cuda.launches = 0
    conv_cuda.launches = 0
    first = det.detect(im)
    torch.cuda.synchronize()
    counts = {"dt1d": dt_cuda.launches, "conv": conv_cuda.launches}
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
        dt1d_launches=counts["dt1d"], conv_launches=counts["conv"],
        deterministic=True, cpu_match_120x160=f"{len(want)} candidates",
        ms_per_image_median=f"{ms:.3f}",
        ms_all=",".join(f"{t:.3f}" for t in times), card=f"'{card}'")
    return counts, ms, det, im


def profile_person26(torch, det, im, wall_ms: float, reps: int = 3) -> None:
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
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    kernels = [
        # device-side events only (kernels, copies): the aten ops that
        # launched them carry the same time again
        e for e in prof.key_averages()
        if dev_us(e) and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    families = {"dt1d": 0.0, "conv": 0.0, "other": 0.0}
    for e in kernels:
        key = "dt1d" if "dt1d_axis2" in e.key else (
            "conv" if "conv_fp32" in e.key else "other")
        families[key] += dev_us(e) / 1e3 / reps
    busy = sum(families.values())
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    log("profile", profiled_wall_ms_per_image=f"{profiled:.3f}",
        device_busy_ms_per_image=f"{busy:.3f}",
        idle_share_vs_unprofiled=f"{max(0.0, 1 - busy / wall_ms):.3f}",
        device_ops_per_image=sum(e.count for e in kernels) // reps,
        **{f"{k}_ms": f"{v:.3f}" for k, v in families.items()},
        top=" | ".join(
            f"{e.key[:48]} {dev_us(e) / 1e3 / reps:.3f}ms x{e.count // reps}"
            for e in top
        ))


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
    log("dt1d_bwd", cases=7, max_abs_err=f"{max(errs):.3e}",
        bound="1e-5*sum|g| per source, 1e-5*sum|g*d^2|,sum|g*d| per map",
        shape="y(320,66,86)+x_aux(320,86,66)", ms=f"{ms:.4f}",
        plain_ms=f"{plain:.4f}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain}


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


def device_ms(torch, prof) -> dict:
    """Device ms of a profiled window by family: K4's backward kernel,
    the DT forward kernel, everything else; plus the ops list."""
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    kernels = [
        e for e in prof.key_averages()
        if dev_us(e) and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    families = {"dt1d_bwd": 0.0, "dt1d": 0.0, "other": 0.0}
    for e in kernels:
        key = "dt1d_bwd" if "dt1d_axis2_bwd" in e.key else (
            "dt1d" if "dt1d_axis2" in e.key else "other")
        families[key] += dev_us(e) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    return {
        "families": families, "busy": sum(families.values()),
        "ops": sum(e.count for e in kernels),
        "top": " | ".join(
            f"{e.key[:48]} {dev_us(e) / 1e3:.3f}ms x{e.count}" for e in top),
    }


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
    whole = device_ms(torch, prof)
    with profile(activities=acts) as prof:
        for i, y in enumerate(labels):
            loss_fn.margin_violation(params, imgs[i], float(y), [m[i] for m in masks])
        torch.cuda.synchronize()
    fwd = device_ms(torch, prof)
    log("train_profile", device_busy_ms_per_step=f"{whole['busy']:.3f}",
        idle_share_vs_unprofiled=f"{max(0.0, 1 - whole['busy'] / wall_ms):.3f}",
        device_ops_per_step=whole["ops"],
        forward_device_ms=f"{fwd['busy']:.3f}",
        backward_and_update_device_ms=f"{whole['busy'] - fwd['busy']:.3f}",
        forward_ops=fwd["ops"],
        **{f"{k}_ms": f"{v:.3f}" for k, v in whole["families"].items()},
        top=whole["top"])


def main() -> int:
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
        from partsbaseddetector_tpu_torch.ops import conv, conv_cuda, dt_cuda
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
    dt_row = check_dt(torch, dt_cuda, gen)
    conv_row = check_conv(torch, conv, conv_cuda, gen)
    check_golden(np, pbd)
    counts, ms, det, im = check_person26(
        torch, np, pbd, dt_cuda, conv_cuda, gen, card
    )
    profile_person26(torch, det, im, ms)
    bwd_row = check_dt_bwd(torch, dt_cuda, gen)
    train = check_train(torch, np, pbd, pbd_train, dt_cuda, card)

    table = {"kernels": [
        {"name": "dt1d_axis2", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d.cu",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:518",
         "also_replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:75",
         "launches": counts["dt1d"], **dt_row},
        {"name": "conv_fp32", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/conv.cu",
         "replaces": "partsbaseddetector_tpu/ops/conv_pallas.py:101",
         "launches": counts["conv"], **conv_row},
        {"name": "dt1d_axis2_bwd", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d_bwd.cu",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:809",
         "launches": train["launches"], **bwd_row},
    ]}
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
