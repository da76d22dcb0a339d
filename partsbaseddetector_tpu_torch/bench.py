"""The port's benchmark: BASELINE configs 1-6 and config 2's hybrid
profile, through the port's serving and training APIs on one card.

    python -m partsbaseddetector_tpu_torch.bench [--samples 3] [--device cuda]

The counterpart of the JAX package's root `bench.py`, with each config's
set-up, metric name and unit carried over. Configs run in its order: 2
(person26 VGA detect, f32, the headline), 6 (the latent train step), 2's
hybrid profile (bf16 + the f32 re-rank) with its rerank parity, 1 (the
face model, one bucket per octave), 4 (64 distinct uint8 frames on the
pipelined path, microbatch 8 beside it), 5 (RGB-D with the depth gate and
the device depth filter) and 3 (the Fourier engine, with its parity
against the spatial engine).

Timing: every timed number is the median of `--samples` samples taken
after a warm-up, with min and max beside it. A sample is a run of
detects (or train steps) bounded by torch.cuda.synchronize(), on the
host clock.

Output, one JSON object a line:
  - first a header: the device, `nvidia-smi`'s name and power limit;
  - per config a compact record (at most 200 bytes: config, metric,
    value = the median rate, unit, vs_baseline, min, max, and `gate`
    where the config checks parity), then {"config": N, "detail": true,
    ...}. A config that raises prints {"config": N, "error": ...} and the
    rest still run; one the budget left (PBD_BENCH_BUDGET seconds,
    default 800) cannot cover prints {"config": N, "skipped": true};
  - at the end every config's record again, then the headline (config
    2, f32) as the last line.
The exit code is 1 when a config erred or failed its gate, else 0.

Baselines: configs 1, 2, 5 and the hybrid profile against the port's
CPUPartsBasedDetector (the native C++ path) on this host, timed once per
host, model and frame size and cached in build/bench_cpu_baseline.json;
config 3 against the spatial engine's rate of config 2; config 4 against
the one-frame-at-a-time rate of the same profile. No floor is checked:
the JAX package's floors (tools/perf_budget.json) are TPU rates. This
file adds no benchmark cell by itself.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import platform
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .cpu_detector import CPUPartsBasedDetector
from .depth import DepthGate
from .detector import PartsBasedDetector
from .models.model import make_face_like_model, make_person_like_model, pack_model
from .train.sgd import batch_root_masks, make_train_step, model_params
from .utils.device import resolve_device

# the frame (parity frames and the train batch take half of it) and the
# train batch; tests run both smaller
IMSIZE = (480, 640)
TRAIN_BATCH = 8
CACHE = Path(__file__).resolve().parent.parent / "build" / "bench_cpu_baseline.json"
# the models by role; tests swap in small ones
MODELS = {"person26": make_person_like_model, "face": make_face_like_model}
COMPACT_BYTES = 200
PARITY_SCORE_TOL = 5e-3  # Fourier against spatial (the card test of the Fourier profile)
CPU_BASELINE = "the port's CPUPartsBasedDetector (native C++), this host"


def buckets_per_octave(model) -> int:
    """Half-octave buckets where the model's interval allows them."""
    return 2 if model.interval % 2 == 0 else 1


@dataclass
class Spread:
    """Rates of `samples` timed samples (items per second)."""

    rates: List[float]

    @property
    def median(self) -> float:
        return statistics.median(self.rates)

    def fields(self, prefix: str = "") -> dict:
        return {f"{prefix}median": self.median, f"{prefix}min": min(self.rates),
                f"{prefix}max": max(self.rates), f"{prefix}samples": self.rates}


@dataclass
class Result:
    """A config's outcome: its rate, its baseline ratio, its gate (None
    where it checks nothing) and the fields of its detail line."""

    rate: Spread
    vs_baseline: Optional[float]
    gate: Optional[bool] = None
    detail: dict = field(default_factory=dict)


@dataclass
class Bench:
    device: torch.device
    samples: int
    imsize: Tuple[int, int]
    train_batch: int
    budget: float
    t0: float = field(default_factory=time.perf_counter)
    # config 2's f32 rate, the baseline of the hybrid and Fourier configs
    person26_rate: Optional[float] = None

    def __post_init__(self):
        rng = np.random.RandomState(0)
        self.im = (rng.rand(*self.imsize, 3) * 255).astype(np.float32)
        self.depth16 = ((1.0 + rng.rand(*self.imsize)) * 1000.0).astype(np.uint16)

    @property
    def small(self) -> Tuple[int, int]:
        """The parity frames and the train batch's size (240x320 at VGA)."""
        return (self.imsize[0] // 2, self.imsize[1] // 2)

    def small_frame(self) -> np.ndarray:
        """The parity frame: the bench frame's top-left quarter."""
        h, w = self.small
        return self.im[:h, :w]

    def remaining(self) -> float:
        return self.budget - (time.perf_counter() - self.t0)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def spread(self, once: Callable, iters: int, items: int,
               warm: Optional[Callable] = None) -> Spread:
        """Warm up (`warm`, else one `once`), then `samples` samples of
        `iters` calls of `once`, each bounded by a synchronize; a call
        handles `items` images."""
        (warm or once)()
        self.sync()
        rates = []
        for _ in range(self.samples):
            t0 = time.perf_counter()
            for _ in range(iters):
                once()
            self.sync()
            rates.append(iters * items / (time.perf_counter() - t0))
        return Spread(rates)

    def cpu_seconds(self, model) -> float:
        """Seconds a CPUPartsBasedDetector detect of the bench frame takes
        on this host, timed once and cached per host, model and size."""
        host = f"{platform.machine()} {_cpu_model()} x{os.cpu_count()}"
        key = f"{model.name}:{self.imsize[0]}x{self.imsize[1]}"
        cache = json.loads(CACHE.read_text()) if CACHE.exists() else {}
        if key not in cache.get(host, {}):
            det = CPUPartsBasedDetector(model)
            t0 = time.perf_counter()
            det.detect(self.im)
            cache.setdefault(host, {})[key] = time.perf_counter() - t0
            CACHE.parent.mkdir(parents=True, exist_ok=True)
            tmp = CACHE.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(json.dumps(cache, indent=1))
            tmp.replace(CACHE)
        return cache[host][key]


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            line = next((s for s in fh if s.startswith("model name")), "")
    except OSError:
        return ""
    return line.split(":", 1)[-1].strip()


def _model(role: str, thresh: float):
    model = MODELS[role]()
    model.thresh = thresh
    return model


def _detector(b: Bench, model, **kw) -> PartsBasedDetector:
    kw.setdefault("max_detections", 256)
    kw.setdefault("buckets_per_octave", buckets_per_octave(model))
    return PartsBasedDetector(model, device=b.device, **kw)


def _resident_rate(b: Bench, det: PartsBasedDetector, iters: int) -> Spread:
    """detect_fn over the frame already on the device, `iters` a sample
    (bench.py's time_fn)."""
    fn = det.detect_fn(b.imsize)
    im = torch.as_tensor(b.im, device=b.device)
    return b.spread(lambda: fn(im), iters, 1)


def _match_boxes(bx_ref, sc_ref, vd_ref, bx, sc, vd, tol_px=0.75):
    """Greedy-match candidates by root-box proximity; return
    (n_query, n_matched, max |score delta| over matches)
    (bench.py::_match_boxes)."""
    qi = np.flatnonzero(vd)
    ri = np.flatnonzero(vd_ref)
    if len(qi) == 0 or len(ri) == 0:
        return len(qi), 0, float("nan")
    matched = 0
    dmax = 0.0
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


# -- the configs -------------------------------------------------------------


def person26(b: Bench) -> Result:
    """Config 2 (bench.py:392-443): person26 at thresh 100, 256
    detections, 20 detects a sample, f32."""
    model = _model("person26", 100.0)
    rate = _resident_rate(b, _detector(b, model), 20)
    b.person26_rate = rate.median
    cpu = b.cpu_seconds(model)
    return Result(rate, cpu * rate.median, detail=dict(
        precision="f32", latency_ms=1e3 / rate.median, cpu_baseline_s=cpu,
        baseline=CPU_BASELINE))


def train_step(b: Bench) -> Result:
    """Config 6 (bench.py:324-381): the latent train step on person26,
    batch 8 at 240x320, labels +1/-1, GT box [40, 40, 280, 200]; 10 steps
    a sample; gate: every loss finite."""
    model = MODELS["person26"]()
    packed = pack_model(model)
    size, batch = b.small, b.train_batch
    step, make_opt = make_train_step(packed, size, latent=True)
    params = model_params(model, b.device)
    opt = make_opt(params.values())
    rng = np.random.RandomState(0)
    imgs = torch.as_tensor(rng.rand(batch, *size, 3).astype(np.float32) * 255.0,
                           device=b.device)
    labels = np.array([1.0, -1.0] * (batch // 2), np.float32)
    h, w = size
    box = [w / 8, h / 6, w * 7 / 8, h * 5 / 6]
    masks = batch_root_masks(packed, size, np.tile(box, (batch, 1)), device=b.device)
    losses = []

    def once():
        _, _, loss = step(params, opt, imgs, masks, labels)
        losses.append(loss)

    steps = 10
    rate = b.spread(once, steps, batch)
    values = [float(x) for x in losses]
    finite = all(math.isfinite(x) for x in values)
    return Result(rate, None, gate=finite, detail=dict(
        batch=batch, imsize=f"{h}x{w}", steps_per_sample=steps,
        step_ms=[1e3 * batch / r for r in rate.rates],
        step_ms_median=1e3 * batch / rate.median, loss_finite=finite,
        final_loss=values[-1],
        baseline="none (train.m runs on the host's MEX kernels)"))


def hybrid(b: Bench) -> Result:
    """Config 2's extras (bench.py:459-544): the hybrid profile (bf16 DP,
    the f32 re-rank on), 20 detects a sample; gate: the rerank parity
    at 240x320 (thresh -1e9, 16 detections), the top-1 box within 0.75 px
    and its score within 1e-3 of f32, 80% of the candidates box-matched."""
    model = _model("person26", 100.0)
    rate = _resident_rate(b, _detector(b, model, dtype=torch.bfloat16), 20)
    lo = _model("person26", -1e9)
    small = b.small_frame()
    o32 = _detector(b, lo, max_detections=16).detect_dense(small)
    ohy = _detector(b, lo, max_detections=16, dtype=torch.bfloat16).detect_dense(small)
    nq, nm, dmax = _match_boxes(o32.boxes, o32.scores, o32.valid,
                                ohy.boxes, ohy.scores, ohy.valid)
    top1 = bool(o32.valid[0] and ohy.valid[0]
                and np.abs(o32.boxes[0] - ohy.boxes[0]).max() <= 0.75
                and abs(float(o32.scores[0]) - float(ohy.scores[0])) <= 1e-3)
    ok = top1 and nm >= max(1, int(0.8 * nq))
    cpu = b.cpu_seconds(model)
    return Result(rate, cpu * rate.median, gate=ok, detail=dict(
        precision="bf16 DP, fp32 top-k re-score and re-rank", latency_ms=1e3 / rate.median,
        vs_f32=rate.median / b.person26_rate if b.person26_rate else None,
        rerank_parity_top1_match=top1, rerank_parity_matched=f"{nm}/{nq}",
        rerank_parity_max_score_delta=dmax if math.isfinite(dmax) else None,
        cpu_baseline_s=cpu, baseline=CPU_BASELINE))


def face(b: Bench) -> Result:
    """Config 1 (bench.py:598-626): the face model (39 parts, interval 5,
    one bucket per octave), thresh 100, 10 detects a sample."""
    model = _model("face", 100.0)
    rate = _resident_rate(b, _detector(b, model), 10)
    cpu = b.cpu_seconds(model)
    return Result(rate, cpu * rate.median, detail=dict(
        latency_ms=1e3 / rate.median, cpu_baseline_s=cpu,
        buckets_per_octave=buckets_per_octave(model),
        baseline=CPU_BASELINE))


def batch64(b: Bench) -> Result:
    """Config 4 (bench.py:628-731): 64 distinct uint8 frames clip(im + i)
    through detect_many's pipelined path (microbatch 1, prefetch 6, top
    64), against one frame at a time (detect: upload, run, read back);
    microbatch 8 beside them."""
    det = _detector(b, _model("person26", 100.0))
    frames = [np.clip(b.im + float(i), 0, 255).astype(np.uint8) for i in range(64)]
    pipelined = lambda fs: det.detect_many(fs, readback_top=64, prefetch=6)
    rate = b.spread(lambda: pipelined(frames), 1, 64, warm=lambda: pipelined(frames[:8]))
    single = b.spread(lambda: [det.detect(f) for f in frames[:8]], 1, 8)
    mb8 = b.spread(lambda: det.detect_many(frames, microbatch=8), 1, 64,
                   warm=lambda: det.detect_many(frames[:8], microbatch=8))
    return Result(rate, rate.median / single.median, detail=dict(
        precision="f32", path="detect_many(microbatch=1, prefetch=6, readback_top=64)",
        **single.fields("single_"), **mb8.fields("microbatch8_"),
        baseline="one frame at a time, detect() per frame, same profile"))


def rgbd(b: Bench) -> Result:
    """Config 5 (bench.py:733-814): person26 at thresh -1e9, 16
    detections, DepthGate(0.6 m, fx 10, tolerance 0.5) and the device
    depth filter, uint16 depth; 20 frames through detect_stream
    (lookahead 4, 2 workers, readback_batch 2) a sample."""
    model = _model("person26", -1e9)
    det = _detector(b, model, max_detections=16, device_depth_filter=True,
                    depth_gate=DepthGate(object_width_m=0.6, fx=10.0, tolerance=0.5))
    frames = [(np.clip(b.im + float(i), 0, 255).astype(np.uint8),
               (b.depth16 + 10 * i).astype(np.uint16)) for i in range(20)]
    kept = []

    def stream(fs):
        kept[:] = [len(c) for c in det.detect_stream(fs, lookahead=4, workers=2,
                                                      readback_batch=2)]

    rate = b.spread(lambda: stream(frames), 1, len(frames), warm=lambda: stream(frames[:8]))
    cpu = b.cpu_seconds(_model("person26", 100.0))
    return Result(rate, cpu * rate.median, detail=dict(
        candidates_last_frame=kept[-1], response_gate=True, depth_wire="uint16 mm",
        baseline=CPU_BASELINE + ", RGB only"))


def fourier(b: Bench) -> Result:
    """Config 3 (bench.py:816-888): the Fourier engine (torch.fft), 10
    detects a sample, against the spatial rate; gate: at 240x320 with
    thresh -1e9 and 64 detections the spatial engine's valid mask and
    scores within 5e-3."""
    rate = _resident_rate(b, _detector(b, _model("person26", 100.0),
                                       conv_engine="fourier"), 10)
    lo = _model("person26", -1e9)
    small = b.small_frame()
    o_sp = _detector(b, lo, max_detections=64).detect_dense(small)
    o_ff = _detector(b, lo, max_detections=64, conv_engine="fourier").detect_dense(small)
    both = o_sp.valid & o_ff.valid
    dscore = float(np.abs(o_sp.scores - o_ff.scores)[both].max()) if both.any() else math.nan
    masks_eq = bool((o_sp.valid == o_ff.valid).all())
    ok = masks_eq and bool(both.any()) and dscore <= PARITY_SCORE_TOL
    return Result(rate, rate.median / b.person26_rate if b.person26_rate else None,
                  gate=ok, detail=dict(
                      parity_max_abs_score_delta=dscore if math.isfinite(dscore) else None,
                      parity_bound=PARITY_SCORE_TOL, parity_valid_masks_equal=masks_eq,
                      parity_candidates=int(both.sum()),
                      baseline="the spatial f32 engine's rate (config 2)"))


@dataclass(frozen=True)
class Config:
    config: int
    profile: Optional[str]
    metric: str
    run: str            # the function's name in this module
    setup_s: float      # the budget's estimates (CONFIGS)
    sample_s: float

    def key(self) -> dict:
        return {"config": self.config, **({"profile": self.profile} if self.profile else {})}


# Budget estimates, seconds of set-up and of one sample: 1.5x what each
# took on one H100 80GB HBM3 at 700 W at 3 samples (the whole run 206 s,
# PERF.md), rounded up.
CONFIGS = [
    Config(2, None, "person26 VGA single-image detect throughput (1 chip)",
           "person26", 10, 6),
    Config(6, None, "person26 latent-SSVM training throughput (1 chip, 240x320)",
           "train_step", 15, 26),
    Config(2, "hybrid", "person26 VGA hybrid detect throughput (1 chip)",
           "hybrid", 5, 8),
    Config(1, None, "face VGA single-image detect throughput (1 chip)", "face", 5, 3),
    Config(4, None, "person26 VGA 64-image batched throughput (1 chip)",
           "batch64", 10, 32),
    Config(5, None, "person26 VGA RGB-D detect+depth-rescore throughput (1 chip)",
           "rgbd", 5, 8),
    Config(3, None, "person26 VGA Fourier-engine detect throughput (1 chip)",
           "fourier", 12, 4),
]


def _compact(cfg: Config, res: Result) -> dict:
    rec = {**cfg.key(), "metric": cfg.metric, "value": round(res.rate.median, 3),
           "unit": "images/sec",
           "vs_baseline": None if res.vs_baseline is None else round(res.vs_baseline, 2),
           "min": round(min(res.rate.rates), 3), "max": round(max(res.rate.rates), 3)}
    if res.gate is not None:
        rec["gate"] = res.gate
    if len(json.dumps(rec)) > COMPACT_BYTES:
        raise ValueError(f"compact record over {COMPACT_BYTES} bytes: {rec}")
    return rec


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip().splitlines()[0]


def run(b: Bench) -> Tuple[List[dict], bool]:
    """Every config in order, each in its own try; returns the records
    (compact, error or skipped) and whether every config ran and held its
    gate."""
    records, ok = [], True
    for cfg in CONFIGS:
        need = cfg.setup_s + cfg.sample_s * b.samples
        if b.remaining() < need:
            rec = {**cfg.key(), "metric": cfg.metric, "skipped": True,
                   "reason": f"budget: {b.remaining():.0f} s left < {need:.0f} s estimated"}
            _emit(rec)
            records.append(rec)
            continue
        t0 = time.perf_counter()
        try:
            res = globals()[cfg.run](b)
            rec = _compact(cfg, res)
        except Exception as e:  # one config's failure must not stop the rest
            rec = {**cfg.key(), "metric": cfg.metric, "error": repr(e)[:COMPACT_BYTES]}
            _emit(rec)
            records.append(rec)
            ok = False
            continue
        _emit(rec)
        _emit({**cfg.key(), "detail": True, "seconds": time.perf_counter() - t0,
               **res.rate.fields(), **res.detail})
        records.append(rec)
        ok = ok and res.gate is not False
    return records, ok


def headline(records: List[dict], elapsed: float) -> dict:
    """Config 2's f32 record, or an error record standing in for it."""
    rec = next((r for r in records if r["config"] == 2 and "profile" not in r), None)
    if rec is None or "value" not in rec:
        rec = {"config": 2, "metric": CONFIGS[0].metric, "value": 0.0,
               "unit": "images/sec", "vs_baseline": None,
               "error": (rec or {}).get("error") or (rec or {}).get("reason")
               or "the headline config never completed"}
    return {**rec, "headline": True, "elapsed_s": elapsed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m partsbaseddetector_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--samples", type=int, default=3, help="timed samples a config")
    args = ap.parse_args(argv)
    if args.samples < 1:
        ap.error("--samples must be >= 1")
    device = resolve_device(args.device)
    b = Bench(device, args.samples, IMSIZE, TRAIN_BATCH,
              float(os.environ.get("PBD_BENCH_BUDGET", "800")))
    _emit({"bench": "partsbaseddetector_tpu_torch", "device": (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "nvidia_smi": _card() if device.type == "cuda" else None,
        "torch": torch.__version__, "samples": b.samples,
        "imsize": "x".join(map(str, b.imsize)),
        "budget_s": b.budget})
    records, ok = run(b)
    for rec in records:
        _emit(rec)
    _emit(headline(records, time.perf_counter() - b.t0))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
