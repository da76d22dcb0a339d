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
                 ties, step 2, a non-integral shift, a = 0 with b != 0, a
                 map narrower than a column tile, H over one source chunk
                 and no multiple of it, dlen no multiple of a thread's
                 run, a map too tall to stay resident and one resident in
                 more than 48 KB of shared memory, more than 65,535 maps
                 refused, the person26 VGA big-bucket shape)
  4. conv        the conv kernel (3xTF32 on the tensor cores) against
                 filter_responses on the card at a person26 VGA bucket,
                 |err| <= 1e-5 * sum|x*w|; events and device ms beside
                 plain, cuDNN, and the 3xTF32 and FP32 bounds; then (after
                 person26) the K2 row, a detect's buckets in one launch
  5. golden      tests/fixtures/golden_model.npz through the port on the
                 card: 15 candidates, |dscore| < 2e-3, boxes within 5e-2
  6. person26    the 26-part model at 480x640: K1, K2 and T2 launched,
                 finite scores, identical candidates on two runs, the
                 same candidates as the CPU path at 120x160, and the
                 steady-state ms/image (median after warm-up)
  7. profile     torch.profiler over person26 VGA: device ms per image
                 by kernel family, the busiest kernels, the idle share
     dt_glue     the device ops that the DT wrappers' own tensor code
                 launches per detect: flatten_maps and the four negated
                 slices of wdef, replayed on one detect's arguments
     transpose   T2 (the x pass's transposes) against its plain version,
                 bit for bit, f32 and int32, single and as a pair in one
                 launch (edge shapes, the person26 and Pallas-probe
                 shapes, more than 65,535 maps, every transpose pair of
                 one detect and of one microbatch-8 program), its
                 gradient; ms and GB/s at (80, 126, 166) beside torch's
                 transposed copy, a contiguous copy of the same bytes
                 and the bound; a pair launch beside two single launches
                 and two torch calls; one detect's transposes summed
  8. dt1d_bwd    the DT's backward kernel (K4) on the card: bit for bit
                 against dt1d_bwd_order_plain (its own order of the sums),
                 the same bits on two runs, and against dt1d_bwd_plain
                 with g_src within 1e-5 * sum|g| per source, g_a and g_b
                 within 1e-5 * sum|g*d^2| and sum|g*d| per map (y pass,
                 x pass with aux, step 2, integer ties, dead outputs,
                 fewer rows than warps, more strips than warps, a map
                 too tall for a shared-memory slab, the person26 240x320
                 finest-bucket shapes);
                 event and device ms of that pair
  9. train       the SGD training step (train/sgd.py::make_train_step) on
                 person26, batch 8 at 240x320, latent positives: both DT
                 kernels launched, finite loss and pools at every step,
                 the defs projection held, two steps at batch 2, 120x160
                 equal to the CPU path's within rtol 1e-4, atol 1e-5, the
                 median ms/step over 5 steps after a warm-up and images/s,
                 then a torch.profiler pass over one step
  9a. mine      the QP trainers' miner (train/detect_tpu.py::TPUMiner) on
                 person26 at 480x640, max_det 64: K2, K1, K1 with aux
                 (K3's x pass) and T2 launched per mine, finite and
                 deterministic; the latent mine on the plain top-1's own
                 part boxes (overlap 0.7), with and without its mixtures
                 fixed, returns the plain top-1's placement; the plain and
                 both latent mines equal the CPU miner's (the plain
                 version of every kernel) at 480x640 and again at 120x160
                 (placements exact, scores 1e-4, boxes 1e-3); set_model
                 on perturbed weights gives a fresh miner's output bit
                 for bit without a new plan; then ms per plain and latent
                 mine (median of 5), the latent masks' host build ms and
                 bytes
     mine_qp     one latent QP round (train/latent.py::train, iters 1,
                 nmax 300, 64 negatives per image) on person26 with two
                 positives and two negatives at 240x320, its features
                 from the pipeline's pyramid (the card miner's, ops/
                 pyramid.py::PyramidKernels): finite weights that moved,
                 validate(), the interval-2 plan built and the interval
                 restored; wall seconds split into mining, feature
                 pyramids, placement features, the QP's set-up, writes
                 and solves (opt, prune, one), and the rest
 10. dt1d_window the adaptive-window DT (K5, K1's core in its window
                 form) against dt1d_window_plain on the card, bit for bit,
                 and against K1 inside out_valid, (-inf, 0) beyond (y
                 pass, x pass with aux, per-column out_valid with 0 and
                 dlen, out_valid all 0 and all dlen, a map streamed
                 through the tile, an integral shift beyond 2^22,
                 all-dead maps, integer ties with and without aux, a == 0
                 with b == 0 and b != 0, the person26 VGA finest-bucket
                 shapes with the plan's out_valid); event ms of K5, K1 and
                 the plain version there, device ms (profiler) and event
                 ms of the bare launches of K5 and K1
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
                 frames, person26): the pyramid features of the first 8
                 frames alone and in one batch bit-identical; detect_many
                 at microbatch 8 launches
                 K1, K2 and T2; its candidates and the pipelined path's
                 (prefetch 6, top 64) equal detect's on 8 frames within
                 1e-5 * max(1, |score|), parts 1e-4; sync ms/image,
                 pipelined and microbatch-8 images/s in turns; device ops
                 and busy ms per image at microbatch 1 and 8 (profiles);
                 the peak device memory at microbatch 8
 15. stream      detect_stream over 12 VGA frames, RGB and (rgb, uint16
                 depth) mixed, gate and device filter on, lookahead 4,
                 2 workers, readback_batch 3: detect's candidates in order
 15a. surfaces   person26 written to .xml and .mat by the port's writers
                 and read back by load_model, every array equal, the
                 .xml's detect = the in-memory model's bit for bit; the
                 ORK-shaped node (apps.pipeline.build of the .xml, a VGA
                 camera, max_overlap 0.1) over 8 RGB-D VGA frames (uint16
                 mm) through process_stream: K1, K2 and T2 launched, each
                 frame = sorted, NMS'd detect bit for bit, ms/frame beside
                 detect_stream's in turns; all six topics on 2 frames
                 (depth valid in a window): finite 3-D outputs, each post
                 stage's host seconds, a flood fill over 20,000 cloud
                 points; apps.messages from frame 0; eval.test_model on the
                 card against the CPU path's best candidates at 120x160
                 (PCK 1.0); visualize_model and hog_picture shapes; equal
                 canvases from the card's and the CPU's candidates; the
                 native CPUPartsBasedDetector against the card (the JAX
                 CPU test's model within 2e-3 / 5e-2; person26 timed);
                 with PyYAML, build_from_file on config_person.by_parts;
                 with PIL, apps.demo.main on PNGs
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
                 to plain f32, a profile and the re-score stage's ms by
                 CUDA events
 19. hybrid_serving  detect_many(microbatch=8) with bf16 over config 4's 64
                 frames: launches, images/s beside f32 in turns, the first
                 8 frames equal to per-frame detect
 20. parallel    parallel/ at world size 1 over NCCL (mesh and first
                 collective timed): person26 VGA, microbatch 8 over 8
                 frames, both engines, batched_detect_fn = detect_batch_fn
                 bit for bit, launches, ms/image of both in turns; the
                 sharded train step (batch 8 at 240x320, two steps) =
                 make_train_step within rtol 1e-4, atol 1e-5, K1 and K4
                 launched, ms/step of both in turns
 21. bf16_plain  bf16 without the re-rank, person26 VGA: K1, K3, T2
                 launched, K2 not; deterministic; ms/image in turns with
                 f32 and the hybrid; the bf16 pyramid batch-invariant
                 (B=1 against B=8); the CPU path's candidates at 120x160
                 by box (80%, scores within 0.05); microbatch-8 images/s
 22. bf16_mine   TPUMiner(dtype=bfloat16) at 480x640: K1, K3, T2 and no
                 K2; deterministic; placements shared with the f32
                 miner's (its top-1 among them) and the CPU bf16 miner's
                 at 120x160 (80%); ms per mine beside f32 in turns
 23. fourier_train  two Fourier-engine train steps on person26 (batch 2,
                 120x160): K1 and K4, no K2; losses and gradients within
                 5e-3 of the spatial engine's, within rtol/atol 1e-4 of the
                 CPU's; ms/step of both engines at batch 8, 240x320
 24. examples    the port's examples (partsbaseddetector_tpu_torch/
                 examples/) on the card: the RGB-D serving demo and the
                 training demo --fast, their launches and seconds
 25. face        config 1's face model (39 parts x 3 mixtures, F = 117)
                 and a 68-part model (F = 204) at 480x640, one bucket per
                 octave, thresh -1e9: K1, K3, K2 and T2 launched,
                 deterministic, ms/image (median of 7), a profile, K2's
                 launch on the detect's buckets against its plain version
                 and the detect's bits, with its event and device ms, and
                 the CPU path's candidates at 120x160
 26. bench       python -m partsbaseddetector_tpu_torch.bench --samples 1
                 in a subprocess: exit 0, a record for each of configs 1-6
                 and the hybrid profile, none skipped, erred or failing
                 its gate, every record again at the end, the headline
                 last; its seconds
 27. dt_public   ops.shift_distance_transform_2d (steps 1 and 2) and
                 ops.distance_transform_2d at person26 VGA's finest
                 bucket, (4, 5, 4, 126, 166) maps: K1 twice (K3 once) and
                 T2 twice per call, values and pointers equal to the CPU
                 path's bit for bit, (Ix, Iy) the packed pointer's fields
 28. lone_launches  20 profiler windows of one bare launch each of K1,
                 K3's x pass, K2, K4, K5, T2 and T1 at the kernel table's
                 shapes, last, in a new process started after the
                 bench (python3 chip_smoke.py --lone-launches): each
                 window records its one kernel event; each kernel's
                 median device ms, and its median ms by CUDA events
                 around one bare launch

The order is 1-6, then the phases whose profiler windows hold a few
launches each (4's K2 row `conv`, 7's `dt_glue` and `transpose`, 8, 10,
17, 16), then 7's `profile` and the rest as listed. Every profiled
window of a hand kernel (the per-family device times of every phase,
utils/profiling.py::profiled and device_ms with launches) must record
exactly the launches the wrappers counted in it, or the phase fails
naming the family and both counts. Phase 28 runs after every window
over whole detects, train steps and the bench, in a process of its own:
in this one, by then, torch.profiler drops lone windows' records
(PERF.md §6).

The second-to-last lines are the kernel table (one JSON object; the K1,
K3, K2 and T2 rows carry hybrid_launches, mine_launches, a plain
mine's launches, and surfaces_launches, the stream node's over its 8
frames, and the launches of phases 20-24 where the kernel runs there:
parallel_launches, bf16_plain_launches, bf16_mine_launches,
fourier_train_launches, examples_launches, and face_launches of
phase 25, whose K2 row also carries face_detects, each model's K2 launch
timed; every row carries lone_launch_device_ms and
lone_launch_event_ms of phase 28) and the
card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or without the
package beside this script, it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import importlib.util
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
# the mine phase's frames: the plain and latent mines, and the QP round
MINE_IMSIZE = (480, 640)
QP_IMSIZE = (240, 320)
# the timed train batches of the parallel and fourier_train phases (the
# train phase's set-up): image size and batch
TRAIN_BATCH = ((240, 320), 8)
# the H100 SXM's published peaks at its 700 W limit: HBM3 bytes/s, FP32
# (non-tensor-core) operations/s and dense TF32 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12


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
# its profiler timer, device_ms(fn, reps=50): the mean device-busy ms of
# fn() without the gaps between launches
device_ms = None
# device_profile(prof, per=1.0): a profiled window's device ms by kernel
# family (utils/profiling.py::FAMILIES), the busy total, the device ops,
# the busiest kernels and the hand kernels' events by family
device_profile = None
# profiled(fn, per=1.0): device_profile of one profiler pass over fn(),
# raising unless it recorded every launch the wrappers counted in it
profiled = None
# window(): the profiler window those take (an opening spin kernel,
# left out of the readings, and pads);
# launch_counts(), launches_since(before), require_launches(profile,
# expected): the wrappers' launch counters by family, and the check
# that a profile recorded as many kernel events
window = launch_counts = launches_since = require_launches = None


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the HBM rate and its operations over the FP32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def conv_bound(nbytes: float, ops: float) -> dict:
    """bound() for a kernel that runs its products on the tensor cores
    in 3xTF32 (K2, T1): three TF32 products per f32 product over the
    TF32 peak, with the FP32 pipes' figure beside it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3.0 * ops / TF32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_tc),
            "bound_by": "bytes" if t_bytes >= t_tc else "operations",
            "bound_pipe": "tensor cores, 3xTF32",
            "fp32_bound_ms": max(t_bytes, ops / FP32_OPS_PER_S * 1e3),
            "bytes_bound_ms": t_bytes}


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
             dead=False, frac=False, ab=None, gen=gen):
        if ints:
            src = torch.randint(-4, 5, (bsz, h, w), generator=gen).float()
            a = -torch.randint(1, 3, (bsz,), generator=gen).float()
            b = torch.randint(-2, 3, (bsz,), generator=gen).float()
        else:
            src = torch.randn((bsz, h, w), generator=gen) * 3
            a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
            b = 0.3 * torch.randn((bsz,), generator=gen)
        shift = torch.randint(-3, 4, (bsz,), generator=gen).float()
        if frac:
            shift = shift + torch.rand((bsz,), generator=gen)
        if ab is not None:
            a.fill_(ab[0])
            b.fill_(ab[1])
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
    # the cases of the redesigned kernel's paths draw from a generator of
    # their own, so that the phases after this one keep their inputs
    own = torch.Generator().manual_seed(6)
    case("fractional_shift", 6, 40, 50, 37, aux=True, nv=(20, 40), frac=True, gen=own)
    case("fractional_shift_step2", 4, 36, 20, 15, step=2, frac=True, gen=own)
    case("a0_b_nonzero", 6, 30, 33, 30, aux=True, nv=(15, 30), ab=(0.0, 0.5), gen=own)
    case("narrower_than_a_tile", 6, 50, 5, 45, aux=True, nv=(10, 50), gen=own)
    case("h_over_one_chunk_ragged", 6, 37, 40, 29, aux=True, nv=(17, 37), gen=own)
    case("dlen_not_a_multiple_of_a_run", 6, 40, 33, 13, nv=(20, 40), dead=True, gen=own)
    case("dlen_beyond_h", 4, 20, 33, 150, aux=True, gen=own)
    case("streamed_tall_map", 2, 1100, 40, 70, aux=True, nv=(900, 1100), gen=own)
    # resident with more than 48 KB of shared memory (the opt-in size)
    case("tall_resident_map", 2, 1000, 20, 40, aux=True, nv=(900, 1000), gen=own)
    try:
        dt_cuda.dt1d(torch.zeros((65536, 2, 2), device=dev),
                     *(torch.zeros((65536,), device=dev),) * 3, 2)
    except ValueError:
        pass
    else:
        raise AssertionError("dt1d: more than 65,535 maps were not refused")
    # person26 VGA big bucket: G=4 parts x S=5 scales x M=4 mixtures of
    # 126x166 maps; the y pass, then the x pass with aux
    g_s_m = 4 * 5 * 4
    yargs, _ = case("p26_y", g_s_m, 126, 166, 126, nv=(120, 126))
    xargs, xaux = case("p26_x_aux", g_s_m, 166, 126, 166, aux=True,
                       nv=(160, 166))
    run_y = lambda: dt_cuda.dt1d(*yargs[:4], 126, 1, nvalid=yargs[4])
    run_x = lambda: dt_cuda.dt1d(*xargs[:4], 166, 1, nvalid=xargs[4], aux=xaux)
    # the event time of the wrapper call, as every earlier run of this
    # script took it (ms), and beside it the kernel's own device time
    # (the profiler's dt1d family: a call of the wrapper also launches
    # flatten_maps' small torch kernels, and at these kernel times CUDA
    # events around it time the host), from a window that recorded every
    # launch
    dev_y = profiled(lambda: [run_y() for _ in range(20)], 20)
    dev_x = profiled(lambda: [run_x() for _ in range(20)], 20)
    dms_y, dms_x = dev_y["families"]["dt1d"], dev_x["families"]["dt1d"]
    ms_y, ms_x = cuda_ms(run_y, reps=20), cuda_ms(run_x, reps=20)
    plain_y = cuda_ms(lambda: dt_cuda.dt1d_plain(*yargs, 126, 1), reps=3)
    plain_x = cuda_ms(lambda: dt_cuda.dt1d_plain(*xargs, 166, 1, aux=xaux),
                      reps=3)
    ms, plain = ms_y + ms_x, plain_y + plain_x
    work = [dt_work(yargs[0], yargs[4], 126), dt_work(xargs[0], xargs[4], 166, xaux)]
    bnd = bound(sum(w[0] for w in work), sum(w[1] for w in work))
    # the x pass alone: K1 on the transposed map with aux, the K3 port
    xpass = {"max_abs_err": errs[-1], "ms": ms_x, "device_ms": dms_x,
             "plain_ms": plain_x, **bound(*work[1]), "library_ms": None}
    log("dt1d", cases=len(errs), exact=True, max_abs_err=max(errs),
        shape="y(80,126,166)+x_aux(80,166,126)", ms=f"{ms:.4f}",
        device_ms=f"{dms_y + dms_x:.4f}",
        wrapper_device_ms=f"{dev_y['busy'] + dev_x['busy']:.4f}",
        wrapper_device_ops=f"{dev_y['ops'] + dev_x['ops']:.0f}",
        plain_ms=f"{plain:.4f}", bound_ms=f"{bnd['bound_ms']:.4f}",
        bound_by=bnd["bound_by"], library_ms=None, x_pass_ms=f"{ms_x:.4f}",
        x_pass_device_ms=f"{dms_x:.4f}",
        x_pass_plain_ms=f"{plain_x:.4f}", x_pass_bound_ms=f"{xpass['bound_ms']:.4f}")
    return {"max_abs_err": max(errs), "ms": ms, "device_ms": dms_y + dms_x,
            "plain_ms": plain, **bnd, "library_ms": None}, xpass


def check_conv(torch, conv, conv_cuda, gen) -> dict:
    """The conv kernel (the grouped launch on one stack, its bank split
    once) against filter_responses at the person26 VGA table shape (plus
    a bank with zero-padded rows): events and the kernel's device time
    beside the plain version, cuDNN and both bounds."""
    dev = DEVICE
    feat = torch.rand((5, 130, 170, 32), generator=gen).to(dev)
    filt = (0.1 * torch.randn((104, 5, 5, 32), generator=gen)).to(dev)
    filt[::3, 3:, :, :] = 0.0  # smaller filters zero-padded in the bank
    bank = conv_cuda.split_bank(filt)
    run = lambda: conv_cuda.filter_responses_grouped([feat], filt, bank)[0]
    got = run()
    want = conv.filter_responses(feat, filt)
    scale = conv.filter_responses(feat.abs(), filt.abs())
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"conv shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = (got - want).abs()
    ratio = (err / (CONV_RTOL * scale).clamp_min(1e-30)).max().item()
    if not bool((err <= CONV_RTOL * scale).all()):
        raise AssertionError(f"conv error exceeds 1e-5*sum|x*w| (x{ratio:.3g})")
    ms = cuda_ms(run, reps=20)
    dms = profiled(lambda: [run() for _ in range(10)], 10)["families"]["conv"]
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
    ops = 2.0 * s_ * oh * ow * k * f_
    bnd = conv_bound(nbytes(feat, filt, want), ops)
    max_err = err.max().item()
    log("conv_table", shape="(5,130,170,32)x(104,5,5,32)", arithmetic="3xTF32",
        max_abs_err=f"{max_err:.3e}", bound="1e-5*sum|x*w|",
        worst_err_over_bound=f"{ratio:.3g}", ms=f"{ms:.4f}",
        device_ms=f"{dms:.4f}", tflops_device=f"{ops / dms / 1e9:.2f}",
        plain_ms=f"{plain:.4f}", library_conv2d_ms=f"{library:.4f}",
        bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
        fp32_bound_ms=f"{bnd['fp32_bound_ms']:.4f}",
        share_of_bound_device=f"{bnd['bound_ms'] / dms:.3f}")
    return {"max_abs_err": max_err, "ms": ms, "device_ms": dms, "plain_ms": plain,
            **bnd, "library_ms": library}


def check_conv_detect(torch, conv, conv_cuda, pipeline, det, im, card,
                      phase: str = "conv", dms=None) -> dict:
    """The K2 row: the conv's main-path launch, every bucket of one
    VGA detect (person26's; the face phase's models) against one split bank, captured from
    det.detect(im). The launch again on the captured stacks equals the
    detect's outputs bit for bit and each output is within 1e-5*sum|x*w|
    of filter_responses; then its event time and its device time beside
    the plain version's, cuDNN's (one conv2d per bucket) and the bounds of
    the detect's work. The device time is the profiler's over ten
    captured launches, or `dms` where given: the `conv` family of the
    detect's own profile (each window complete, held to the counters)."""
    calls = []
    orig = pipeline.filter_responses_grouped

    def record(feats, filt, bank=None):
        outs = orig(feats, filt, bank)
        calls.append((feats, filt, bank, [o.clone() for o in outs]))
        return outs

    pipeline.filter_responses_grouped = record
    try:
        det.detect(im)
    finally:
        pipeline.filter_responses_grouped = orig
    if len(calls) != 1 or calls[0][2] is None:
        raise AssertionError(f"{phase}: {len(calls)} grouped calls in a detect, or no split bank")
    feats, filt, bank, seen = calls[0]
    run = lambda: conv_cuda.filter_responses_grouped(feats, filt, bank)
    before = conv_cuda.launches
    got = run()
    launches = conv_cuda.launches - before
    ratio, err_max, nbytes_, ops = 0.0, 0.0, nbytes(filt), 0.0
    for x, g, s_ in zip(feats, got, seen):
        want = conv.filter_responses(x, filt)
        scale = conv.filter_responses(x.abs(), filt.abs())
        if g.shape != want.shape or not torch.equal(g, s_):
            raise AssertionError(f"{phase}: bucket {tuple(x.shape)} differs from the detect's")
        err = (g - want).abs()
        if not bool((err <= CONV_RTOL * scale).all()):
            raise AssertionError(f"{phase}: bucket {tuple(x.shape)} exceeds 1e-5*sum|x*w|")
        ratio = max(ratio, (err / (CONV_RTOL * scale).clamp_min(1e-30)).max().item())
        err_max = max(err_max, err.max().item())
        s_n, oh, ow, f_ = want.shape
        ops += 2.0 * s_n * oh * ow * filt[0].numel() * f_
        nbytes_ += nbytes(x, want)
    ms = cuda_ms(run, reps=20)
    if dms is None:
        dms = profiled(lambda: [run() for _ in range(10)], 10)["families"]["conv"]
    plain = cuda_ms(lambda: [conv.filter_responses(x, filt) for x in feats], reps=3)
    w_nchw = filt.permute(0, 3, 1, 2).contiguous()
    x_nchw = [x.permute(0, 3, 1, 2).contiguous() for x in feats]
    conv2d = torch.nn.functional.conv2d
    library = cuda_ms(lambda: [conv2d(x, w_nchw) for x in x_nchw], reps=5)
    bnd = conv_bound(nbytes_, ops)
    log(phase, what=f"one {det.name} VGA detect's buckets, one grouped launch",
        buckets=len(feats), filters=filt.shape[0], launches=launches,
        shapes=";".join("x".join(map(str, x.shape[:3])) for x in feats),
        arithmetic="3xTF32", max_abs_err=f"{err_max:.3e}", bound="1e-5*sum|x*w|",
        worst_err_over_bound=f"{ratio:.3g}", equal_to_detect=True,
        gflop=f"{ops / 1e9:.3f}", mbytes=f"{nbytes_ / 1e6:.1f}", ms=f"{ms:.4f}",
        device_ms=f"{dms:.4f}", tflops_device=f"{ops / dms / 1e9:.2f}",
        plain_ms=f"{plain:.4f}", library_conv2d_ms=f"{library:.4f}",
        bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
        fp32_bound_ms=f"{bnd['fp32_bound_ms']:.4f}",
        share_of_bound_device=f"{bnd['bound_ms'] / dms:.3f}", card=f"'{card}'")
    if launches != 1:
        raise AssertionError(f"{phase}: a detect's buckets took {launches} launches")
    return {"max_abs_err": err_max, "ms": ms, "device_ms": dms, "plain_ms": plain,
            **bnd, "library_ms": library, "gflop": ops / 1e9, "filters": filt.shape[0]}


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


def difference(a, b) -> str:
    """What same_candidates would trip over, for a gate's failure message."""
    if len(a) != len(b):
        return f"{len(a)} candidates against {len(b)}"
    pairs = list(zip(a, b))
    dscore = [abs(x.score - y.score) for x, y in pairs]
    dbox = [float(abs(x.parts - y.parts).max()) for x, y in pairs]
    other = sum(x.component != y.component or not (x.mixtures == y.mixtures).all()
                for x, y in pairs)
    worst = max(range(len(pairs)), key=lambda i: (dbox[i], dscore[i])) if pairs else -1
    return (f"{len(a)} candidates, max |dscore| {max(dscore, default=0.0):.3e}, "
            f"max |dbox| {max(dbox, default=0.0):.3e}, "
            f"{sum(d > 1e-3 for d in dbox)} boxes off by more than 1e-3, "
            f"{other} with another component or mixture, worst rank {worst}")


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
        raise AssertionError("person26: CUDA and CPU paths differ at 120x160: "
                             + difference(got, want))
    log("person26", imsize="480x640", buckets_per_octave=bpo,
        candidates=len(first), top_score=f"{first[0].score:.4f}",
        dt1d_launches=counts["dt1d"], dt1d_xpass_launches=counts["dt1d_aux"],
        conv_launches=counts["conv"], transpose_launches=counts["transpose"],
        deterministic=True, cpu_match_120x160=f"{len(want)} candidates",
        ms_per_image_median=f"{ms:.3f}",
        ms_all=",".join(f"{t:.3f}" for t in times), card=f"'{card}'")
    return counts, ms, det, im


def profile_person26(torch, det, im, wall_ms: float, reps: int = 3,
                     phase: str = "profile") -> dict:
    """torch.profiler over `reps` person26 VGA detects: device time per
    image by kernel family and for the busiest kernels, and the idle
    share against the unprofiled wall time `wall_ms` (the profiler's own
    host cost inflates the profiled one), from a window that recorded
    every hand-kernel launch. Returns the families."""
    before = launch_counts()
    with window() as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            det.detect(im)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    got = device_profile(prof, reps)
    require_launches(got, launches_since(before))
    log(phase, profiled_wall_ms_per_image=f"{wall:.3f}",
        device_busy_ms_per_image=f"{got['busy']:.3f}",
        idle_share_vs_unprofiled=f"{max(0.0, 1 - got['busy'] / wall_ms):.3f}",
        device_ops_per_image=f"{got['ops']:.0f}",
        **{f"{k}_ms": f"{v:.3f}" for k, v in got["families"].items()},
        top=got["top"])
    return got["families"]


def check_dt_bwd(torch, dt_cuda, kernels, gen) -> dict:
    """K4's backward kernel against dt1d_bwd_order_plain (its own order
    of the sums) bit for bit, the same bits on a second run, and within
    the magnitude rule of dt1d_bwd_plain, on the same forward outputs;
    returns its timing at the person26 240x320 finest bucket (G=8 parts
    x S=10 scales x M=4 mixtures of 66x86 maps)."""
    dev = DEVICE
    errs = []
    lib = kernels.library()

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
        again = dt_cuda.dt1d_bwd(*args)
        layout = (lib.pbd_dt1d_bwd_strips(h, w, dlen), lib.pbd_dt1d_bwd_segments(h, w, dlen))
        exact = dt_cuda.dt1d_bwd_order_plain(*args, max(1, layout[0]), layout[1])
        want = dt_cuda.dt1d_bwd_plain(*args)
        bounds = [DT_BWD_RTOL * m for m in dt_cuda.dt1d_bwd_magnitudes(*args)]
        torch.cuda.synchronize()
        for what, x, y, z, e, bound in zip(("g_src", "g_a", "g_b"), got, want, again,
                                           exact, bounds):
            if x.shape != y.shape:
                raise AssertionError(f"dt1d_bwd {name}: {what} shape {tuple(x.shape)}")
            if not torch.equal(x, e):
                raise AssertionError(
                    f"dt1d_bwd {name}: {what} differs from dt1d_bwd_order_plain "
                    f"(strips, segments {layout})")
            if not torch.equal(x, z):
                raise AssertionError(f"dt1d_bwd {name}: {what} differs between two runs")
            err = (x - y).abs()
            if not bool((err <= bound).all()):
                ratio = (err / bound.clamp_min(1e-30)).max().item()
                raise AssertionError(
                    f"dt1d_bwd {name}: {what} exceeds its bound (x{ratio:.3g})")
            errs.append(err.max().item())
        return args, layout

    case("ypass", 7, 40, 50, 37)
    case("xpass_aux", 7, 50, 40, 45, aux=True)
    case("step2", 5, 36, 20, 15, step=2)
    case("ties_aux", 6, 24, 40, 24, aux=True, ints=True)
    case("dead", 6, 30, 33, 30, aux=True, dead=True)
    case("fewer_rows_than_warps", 5, 9, 70, 5)
    case("more_strips_than_warps", 4, 20, 300, 17, aux=True)
    _, tall = case("too_tall_for_a_slab", 2, 1900, 40, 60, aux=True)
    if tall[0] != 0:
        raise AssertionError("dt1d_bwd: the tall map did not take the global-memory path")
    yargs, ylay = case("p26_240x320_y", 8 * 10 * 4, 66, 86, 66)
    xargs, xlay = case("p26_240x320_x_aux", 8 * 10 * 4, 86, 66, 86, aux=True)
    pair = lambda: (dt_cuda.dt1d_bwd(*yargs), dt_cuda.dt1d_bwd(*xargs))
    ms = cuda_ms(pair, reps=20)
    dev_ms = statistics.median(device_ms(pair, reps=20, launches={"dt1d_bwd": 2})
                               for _ in range(3))
    plain = cuda_ms(lambda: dt_cuda.dt1d_bwd_plain(*yargs), reps=20)
    plain += cuda_ms(lambda: dt_cuda.dt1d_bwd_plain(*xargs), reps=20)
    # per output: d, g*d, g*d*d and three sums, ~6 FP32 operations; g,
    # out, ptr and shift read, g_src, g_a and g_b written
    moved, ops = 0, 0.0
    for g, _, _, shift, h, _, _ in (yargs, xargs):
        moved += 3 * nbytes(g) + 3 * nbytes(shift) + nbytes(g) // g.shape[1] * h
        ops += 6.0 * g.numel()
    bnd = bound(moved, ops)
    log("dt1d_bwd", cases=10, max_abs_err=f"{max(errs):.3e}", exact_order=True,
        deterministic=True, strips_segments=f"y{ylay},x{xlay},tall{tall}".replace(" ", ""),
        bound="1e-5*sum|g| per source, 1e-5*sum|g*d^2|,sum|g*d| per map",
        shape="y(320,66,86)+x_aux(320,86,66)", ms=f"{ms:.4f}",
        device_ms=f"{dev_ms:.4f}", plain_ms=f"{plain:.4f}",
        bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"], library_ms=None)
    return {"max_abs_err": max(errs), "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            **bnd, "library_ms": None}


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
    share is the difference; each window recorded every hand-kernel
    launch."""
    step, loss_fn, params, opt, imgs, masks, labels = ctx
    def fwd():
        for i, y in enumerate(labels):
            loss_fn.margin_violation(params, imgs[i], float(y), [m[i] for m in masks])

    whole = profiled(lambda: step(params, opt, imgs, masks, labels))
    fwd = profiled(fwd)
    log("train_profile", device_busy_ms_per_step=f"{whole['busy']:.3f}",
        idle_share_vs_unprofiled=f"{max(0.0, 1 - whole['busy'] / wall_ms):.3f}",
        device_ops_per_step=f"{whole['ops']:.0f}",
        forward_device_ms=f"{fwd['busy']:.3f}",
        backward_and_update_device_ms=f"{whole['busy'] - fwd['busy']:.3f}",
        forward_ops=f"{fwd['ops']:.0f}",
        **{f"{k}_ms": f"{v:.3f}" for k, v in whole["families"].items()},
        top=whole["top"])


def mine_counts(dt_cuda, conv_cuda, tc) -> dict:
    return {"dt1d": dt_cuda.launches, "dt1d_aux": dt_cuda.aux_launches,
            "conv": conv_cuda.launches, "transpose": tc.launches}


def zero_counts(dt_cuda, conv_cuda, tc) -> None:
    dt_cuda.launches = dt_cuda.aux_launches = 0
    conv_cuda.launches = 0
    tc.launches = 0


def same_placements(np, a, b, score_tol=0.0, box_tol=0.0) -> bool:
    """Two miners' detection dicts: the same placements (level,
    component, per-part grid coords, mixtures), scores within score_tol
    and boxes within box_tol."""
    return len(a) == len(b) and all(
        x["level"] == y["level"] and x["component"] == y["component"]
        and all(np.array_equal(x[k], y[k]) for k in ("xs", "ys", "mixtures"))
        and abs(x["score"] - y["score"]) <= score_tol
        and float(np.abs(x["boxes"] - y["boxes"]).max()) <= box_tol
        for x, y in zip(a, b)
    )


def placement_difference(np, a, b) -> str:
    """What same_placements would trip over, for a gate's failure message."""
    if len(a) != len(b):
        return f"{len(a)} detections against {len(b)}"
    pairs = list(zip(a, b))
    other = [i for i, (x, y) in enumerate(pairs)
             if (x["level"], x["component"]) != (y["level"], y["component"])
             or not all(np.array_equal(x[k], y[k]) for k in ("xs", "ys", "mixtures"))]
    dscore = max((abs(x["score"] - y["score"]) for x, y in pairs), default=0.0)
    dbox = max((float(np.abs(x["boxes"] - y["boxes"]).max()) for x, y in pairs), default=0.0)
    return (f"{len(a)} detections, {len(other)} other placements (first rank "
            f"{other[0] if other else -1}), max |dscore| {dscore:.3e}, max |dbox| {dbox:.3e}")


def timed_mine(torch, miner, im, **kw) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = miner.detect(im, thresh=-1e8, **kw)
    torch.cuda.synchronize()
    return dets, (time.perf_counter() - t0) * 1e3


def perturbed(np, model, seed):
    """The model with seeded perturbed weights (what a QP update does)."""
    import dataclasses

    rng = np.random.RandomState(seed)
    out = dataclasses.replace(model)
    out.filters = [f + rng.randn(*f.shape).astype(f.dtype) * 0.05
                   for f in model.filters]
    out.biases = model.biases + 0.1
    return out


@contextlib.contextmanager
def qp_round_clock(torch, latent, detect_tpu, clock, miners):
    """Time latent.train's spans: its mining (each miner.detect,
    synchronized), feature pyramids and placement features, and its QP:
    the solver's set-up, its writes, and its solves (opt, prune and one;
    a call inside another is the outer one's time). Record its miners."""
    saved = (latent.feature_pyramid, latent.placement_feature,
             detect_tpu.TPUMiner, latent.QPSolver)
    depth = {"qp_solve": 0}

    def timed(key, fn, sync=False):
        def run(*args, **kwargs):
            outer = depth.get(key, 0) == 0
            depth[key] = depth.get(key, 0) + 1
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
            finally:
                depth[key] -= 1
            if outer:
                clock[key] += time.perf_counter() - t0
            return out
        return run

    class Miner(detect_tpu.TPUMiner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            miners.append(self)
            self.detect = timed("mine", self.detect, sync=True)

    class Solver(saved[3]):
        def __init__(self, *args, **kwargs):
            timed("qp_setup", super().__init__)(*args, **kwargs)
            self.write = timed("qp_write", self.write)
            for name in ("opt", "prune", "one"):
                setattr(self, name, timed("qp_solve", getattr(self, name)))

    latent.feature_pyramid = timed("feature_pyramid", saved[0], sync=True)
    latent.placement_feature = timed("placement_feature", saved[1])
    detect_tpu.TPUMiner = Miner
    latent.QPSolver = Solver
    try:
        yield
    finally:
        (latent.feature_pyramid, latent.placement_feature,
         detect_tpu.TPUMiner, latent.QPSolver) = saved


def check_mine(torch, np, pbd, dt_cuda, conv_cuda, tc, gen, card) -> dict:
    """The QP trainers' miner (train/detect_tpu.py::TPUMiner) on person26:
    plain and latent mines at MINE_IMSIZE, held against the CPU miner
    (the plain version of every kernel) at that size before they are
    timed, a weight update without re-planning, the card against the CPU
    at 120x160, and one latent QP round (train/latent.py::train) at
    QP_IMSIZE. Returns the launches of one plain mine."""
    from partsbaseddetector_tpu_torch.train import detect_tpu, latent

    model = pbd.make_person_like_model()
    if not detect_tpu._filters_unique_per_part(model):
        raise AssertionError("mine: person26 would take the shared-filter route")
    im = torch.randint(0, 256, (*MINE_IMSIZE, 3), generator=gen,
                       dtype=torch.uint8).numpy()
    miner = detect_tpu.TPUMiner(model, max_det=64, device=DEVICE)
    imsize = "x".join(map(str, MINE_IMSIZE))

    # plain mine: the launches of one mine, then determinism
    zero_counts(dt_cuda, conv_cuda, tc)
    first, first_ms = timed_mine(torch, miner, im)
    counts = mine_counts(dt_cuda, conv_cuda, tc)
    if min(counts.values()) <= 0:
        raise AssertionError(f"mine: a kernel was not launched: {counts}")
    if len(first) != 64 or not all(
        np.isfinite(d["score"]) and np.isfinite(d["boxes"]).all()
        and d["boxes"].shape == (26, 4) for d in first
    ):
        raise AssertionError(f"mine: {len(first)} detections, malformed or not finite")
    if not same_placements(np, miner.detect(im, thresh=-1e8), first):
        raise AssertionError("mine: two plain mines differ")

    # latent mines on the top-1's own part boxes: the top-1 satisfies
    # them with IoU 1 and is the global maximum, so it comes back
    top = first[0]
    lat_kw = dict(part_boxes=top["boxes"], overlap=0.7)
    fixed_kw = dict(lat_kw, fixed_mixtures=top["mixtures"])
    zero_counts(dt_cuda, conv_cuda, tc)
    lat, _ = timed_mine(torch, miner, im, **lat_kw)
    lat_counts = mine_counts(dt_cuda, conv_cuda, tc)
    if not same_placements(np, lat, first[:1], score_tol=math.inf, box_tol=math.inf):
        raise AssertionError("mine: the latent top-1 is not the plain top-1")
    fixed, _ = timed_mine(torch, miner, im, **fixed_kw)
    if not same_placements(np, fixed, first[:1], score_tol=math.inf, box_tol=math.inf):
        raise AssertionError("mine: the fixed-mixtures latent top-1 is not the plain top-1")
    dscore_latent = abs(lat[0]["score"] - top["score"])

    # the same three mines through the CPU miner, whose wrappers run the
    # plain version of every kernel on the same inputs and shapes
    cpu_miner = detect_tpu.TPUMiner(model, max_det=64, device="cpu")
    t0 = time.perf_counter()
    dscore_cpu = 0.0
    for got, kw, what in ((first, {}, "plain"), (lat, lat_kw, "latent"),
                          (fixed, fixed_kw, "fixed-mixtures latent")):
        want = cpu_miner.detect(im, thresh=-1e8, **kw)
        if not want or not same_placements(np, got, want, score_tol=1e-4, box_tol=1e-3):
            raise AssertionError(f"mine: card and CPU {what} mines differ at {imsize}: "
                                 + placement_difference(np, got, want))
        dscore_cpu = max([dscore_cpu] + [abs(g["score"] - w["score"])
                                         for g, w in zip(got, want)])
    cpu_s = time.perf_counter() - t0

    # times, after the checks
    plain_ms = [timed_mine(torch, miner, im)[1] for _ in range(5)]
    packed, plan, _ = miner._get_plan(im.shape[:2])
    t0 = time.perf_counter()
    masks = miner._latent_masks(packed, plan, top["boxes"], 0.7, None)
    mask_ms = (time.perf_counter() - t0) * 1e3
    mask_bytes = sum(m.nbytes for m in masks)
    latent_ms = [timed_mine(torch, miner, im, **lat_kw)[1] for _ in range(5)]

    # a weight update: the same plans, a fresh miner's bits
    nplans = len(miner._plans)
    moved = perturbed(np, model, seed=1)
    miner.set_model(moved)
    got = miner.detect(im, thresh=-1e8)
    want = detect_tpu.TPUMiner(moved, max_det=64, device=DEVICE).detect(im, thresh=-1e8)
    if not same_placements(np, got, want):
        raise AssertionError("mine: set_model differs from a fresh miner")
    if len(miner._plans) != nplans:
        raise AssertionError(f"mine: set_model re-planned ({nplans} -> {len(miner._plans)})")

    # the card against the CPU at 120x160, plain and latent
    small = im[:120, :160]
    card_miner = detect_tpu.TPUMiner(model, max_det=64, device=DEVICE)
    got = card_miner.detect(small, thresh=-1e8)
    want = cpu_miner.detect(small, thresh=-1e8)
    small_kw = dict(part_boxes=want[0]["boxes"], overlap=0.7)
    got_l = card_miner.detect(small, thresh=-1e8, **small_kw)
    want_l = cpu_miner.detect(small, thresh=-1e8, **small_kw)
    for g, w, what in ((got, want, "plain"), (got_l, want_l, "latent")):
        if not w or not same_placements(np, g, w, score_tol=1e-4, box_tol=1e-3):
            raise AssertionError(f"mine: card and CPU {what} mines differ at 120x160: "
                                 + placement_difference(np, g, w))

    qp = check_qp_round(torch, np, pbd, model, latent, detect_tpu,
                        dt_cuda, conv_cuda, tc, gen)
    log("mine", model="person26", imsize=imsize, max_det=64,
        dt1d_launches=counts["dt1d"], dt1d_xpass_launches=counts["dt1d_aux"],
        conv_launches=counts["conv"], transpose_launches=counts["transpose"],
        latent_launches=",".join(f"{k}:{v}" for k, v in lat_counts.items()),
        deterministic=True, top_score=f"{top['score']:.4f}",
        latent_top1_is_plain_top1=True, latent_dscore=f"{dscore_latent:.3e}",
        fixed_mixtures_top1=True,
        cpu_match=f"'{imsize} plain 64, latent 1, fixed-mixtures latent 1'",
        cpu_max_dscore=f"{dscore_cpu:.3e}", cpu_mines_s=f"{cpu_s:.3f}",
        set_model_equals_fresh=True, plans=nplans,
        cpu_match_120x160=f"{len(want)}+{len(want_l)} detections",
        first_mine_ms=f"{first_ms:.3f}",
        ms_per_plain_mine_median=f"{statistics.median(plain_ms):.3f}",
        ms_per_latent_mine_median=f"{statistics.median(latent_ms):.3f}",
        latent_mask_build_ms=f"{mask_ms:.3f}", latent_mask_bytes=mask_bytes,
        plain_ms_all=",".join(f"{t:.3f}" for t in plain_ms),
        latent_ms_all=",".join(f"{t:.3f}" for t in latent_ms), card=f"'{card}'")
    log("mine_qp", **qp)
    return counts


def check_qp_round(torch, np, pbd, model, latent, detect_tpu,
                   dt_cuda, conv_cuda, tc, gen) -> dict:
    """One latent QP round (train.m) on person26: two positives and two
    negatives at QP_IMSIZE, the positives' part boxes from a plain mine's
    best placement that train.m's minsize rule keeps. With the miner on
    the card, latent.train cuts the QP's features from the pipeline's own
    pyramid (ops/pyramid.py::PyramidKernels)."""
    import copy

    frames = [torch.randint(0, 256, (*QP_IMSIZE, 3), generator=gen,
                            dtype=torch.uint8).numpy() for _ in range(4)]
    minsize = float(np.prod(np.asarray(model.effective_maxsize()) * model.sbin))
    probe = detect_tpu.TPUMiner(model, max_det=64, device=DEVICE)
    positives = []
    for im in frames[:2]:
        for d in probe.detect(im, thresh=-1e8):
            b = d["boxes"]
            if ((b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1) >= minsize).all():
                positives.append({"im": im, "points": None, "boxes": b})
                break
        else:
            raise AssertionError("mine_qp: no placement passes the minsize rule")
    negatives = [{"im": im} for im in frames[2:]]
    clock = dict.fromkeys(("mine", "feature_pyramid", "placement_feature",
                           "qp_setup", "qp_write", "qp_solve"), 0.0)
    miners = []
    zero_counts(dt_cuda, conv_cuda, tc)
    t0 = time.perf_counter()
    with qp_round_clock(torch, latent, detect_tpu, clock, miners):
        trained = latent.train(
            copy.deepcopy(model), positives, negatives, warp=False, iters=1,
            nmax=300, max_neg_per_image=64, device=DEVICE,
        )
    wall = time.perf_counter() - t0
    counts = mine_counts(dt_cuda, conv_cuda, tc)
    if min(counts.values()) <= 0:
        raise AssertionError(f"mine_qp: a kernel was not launched: {counts}")
    pools = [*trained.filters, trained.biases, *trained.defs]
    if not all(np.isfinite(p).all() for p in pools) or not np.isfinite(trained.thresh):
        raise AssertionError("mine_qp: the trained weights are not finite")
    trained.validate()
    if len(miners) != 1 or (*QP_IMSIZE, 2) not in miners[0]._plans:
        raise AssertionError(
            f"mine_qp: no interval-2 plan ({[sorted(m._plans) for m in miners]})")
    if trained.interval != model.interval:
        raise AssertionError("mine_qp: the interval was not restored")
    moved = max(float(np.abs(a - b).max())
                for a, b in zip(trained.filters, model.filters))
    if moved == 0.0:
        raise AssertionError("mine_qp: the round kept the model (no positive mined?)")
    rest_s = wall - sum(clock.values())
    return {"imsize": "x".join(map(str, QP_IMSIZE)), "positives": 2, "negatives": 2, "nmax": 300,
            "plans": "+".join("x".join(map(str, k)) for k in sorted(miners[0]._plans)),
            "wall_s": f"{wall:.3f}", **{f"{k}_s": f"{v:.3f}" for k, v in clock.items()},
            "rest_s": f"{rest_s:.3f}", "thresh": f"{trained.thresh:.6f}",
            "max_filter_change": f"{moved:.3e}",
            "launches": ",".join(f"{k}:{v}" for k, v in counts.items())}


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


def check_dt_window(torch, dt_cuda, variants, gen, det, im) -> dict:
    """K5 against dt1d_window_plain (bit for bit, don't-care outputs
    included) and against K1 inside out_valid; returns its timing beside
    K1's and the plain version's at the person26 VGA finest bucket, on
    the DT inputs and consumer extents a real detect gives it
    (tools/kernel_variants.py::window_passes)."""
    dev = DEVICE

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

    def case(name, bsz, h, w, dlen, aux=False, ints=False, dead=False, ab=None,
             ov_fill=None, big_shift=False):
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
        if big_shift:  # integral, beyond 2^22: K1's general path
            shift += float(2**22 + 5)
        ov = torch.randint(0, dlen + 1, (bsz, w), generator=gen, dtype=torch.int32)
        ov[:, 0], ov[:, 1] = 0, dlen  # per-column extents include 0 and dlen
        if ov_fill is not None:
            ov.fill_(ov_fill)
        ax = torch.randint(0, 4096, (bsz, h, w), generator=gen,
                           dtype=torch.int32) if aux else None
        args = [t.to(dev) for t in (src, a, b, shift, nvalid, ov)]
        return run(name, *args, dlen, None if ax is None else ax.to(dev))

    cases = [
        case("ypass", 6, 40, 50, 37),
        case("out_valid_all_zero", 6, 40, 50, 37, ov_fill=0),
        case("out_valid_all_dlen", 6, 40, 50, 37, aux=True, ov_fill=37),
        case("streamed_tall_map", 2, 1100, 40, 70, aux=True),
        case("shift_beyond_2_22", 5, 40, 33, 37, aux=True, big_shift=True),
        case("xpass_aux", 6, 50, 40, 45, aux=True),
        case("dead", 6, 30, 33, 30, aux=True, dead=True),
        case("ties", 8, 24, 40, 24, ints=True),
        case("ties_aux", 8, 24, 40, 24, ints=True, aux=True),
        case("a0_b0", 6, 30, 33, 30, ab=(0.0, 0.0)),
        case("a0_b_nonzero", 6, 30, 33, 30, aux=True, ab=(0.0, 0.5)),
    ]
    yargs, xargs = variants.window_passes(torch, det, im)
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

    # the kernels alone, without the wrappers' own tensor code (whose
    # device ops the profiler would add): the launches on flat arguments
    k5_alone = lambda: [dt_cuda._dt1d_window_cuda(*p) for p in (yargs, xargs)]
    k1_alone = lambda: [dt_cuda._dt1d_cuda(*p[:5], p[6], 1, p[7]) for p in (yargs, xargs)]
    # in turns, as the kernels and the plain version share the card;
    # device time (profiler, windows that recorded every launch) beside
    # the wrappers' event time, and events around the bare launches (each
    # takes tens of us, more than the host needs to launch it)
    ms, k1_ms, plain_ms, dev_ms, k1_dev, bare, k1_bare = ([] for _ in range(7))
    for _ in range(3):
        ms.append(cuda_ms(k5, reps=10))
        k1_ms.append(cuda_ms(k1, reps=10))
        dev_ms.append(profiled(lambda: [k5_alone() for _ in range(10)], 10)
                      ["families"]["dt1d_window"])
        k1_dev.append(profiled(lambda: [k1_alone() for _ in range(10)], 10)
                      ["families"]["dt1d"])
        bare.append(cuda_ms(k5_alone, reps=10))
        k1_bare.append(cuda_ms(k1_alone, reps=10))
        plain_ms.append(cuda_ms(plain, reps=3))
    shape = (f"y{tuple(yargs[0].shape)}+x_aux{tuple(xargs[0].shape)}")
    ms, k1_ms, plain_ms = min(ms), min(k1_ms), min(plain_ms)
    dev_ms, k1_dev = statistics.median(dev_ms), statistics.median(k1_dev)
    bare, k1_bare = statistics.median(bare), statistics.median(k1_bare)
    inside = sum(c[0] for c in cases[-2:])
    dont = sum(c[1] for c in cases[-2:])
    # the chunk prune makes the scan data-dependent: count the least
    # work, each exact output evaluating at least one source (~5
    # operations); inputs read, outputs written once
    moved = sum(nbytes(a[0], a[5], a[7]) + 16 * a[0].shape[0]
                + 8 * a[0].shape[0] * a[6] * a[0].shape[2] for a in (yargs, xargs))
    bnd = bound(moved, 5.0 * inside)
    log("dt1d_window", cases=len(cases), exact=True, max_abs_err=0.0,
        shape=shape, p26_outputs_exact=inside, p26_outputs_dont_care=dont,
        ms=f"{ms:.4f}", k1_ms=f"{k1_ms:.4f}", device_ms=f"{dev_ms:.4f}",
        k1_device_ms=f"{k1_dev:.4f}", bare_launch_ms=f"{bare:.4f}",
        k1_bare_launch_ms=f"{k1_bare:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
        library_ms=None)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "k1_ms": k1_ms,
            "device_ms": dev_ms, "k1_device_ms": k1_dev, "bare_launch_ms": bare,
            "k1_bare_launch_ms": k1_bare, **bnd, "library_ms": None}


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
    got, want = card_det.detect(small), cpu.detect(small)
    if not same_candidates(got, want, score_tol=1e-4, box_tol=1e-3):
        raise AssertionError("fourier: CUDA and CPU paths differ at 120x160: "
                             + difference(got, want))
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
    got_c, want_c = det.detect(small, dsmall), cpu.detect(small, dsmall)
    if not same_candidates(got_c, want_c, score_tol=1e-4, box_tol=1e-3):
        raise AssertionError("rgbd: CUDA and CPU paths differ at 120x160: "
                             + difference(got_c, want_c))
    log("rgbd", imsize="x".join(map(str, im.shape[:2])), depth="uint16 mm", candidates=int(dense.valid.sum()),
        kept_by_depth_filter=kept, dt1d_launches=counts["dt1d"],
        conv_launches=counts["conv"],
        ms_per_image_median=f"{statistics.median(times):.3f}",
        ms_all=",".join(f"{t:.3f}" for t in times),
        cpu_match_120x160=f"{int(want.depth_keep.sum())} of {len(want.depth_keep)} kept",
        card=f"'{card}'")


def eager_dp(det) -> None:
    """Drop det's graphs (ops/dp_graph.py), so that its next call of
    each shape runs the DP (and the pyramid) eagerly. A replayed graph
    runs none of the DP's Python: the phases that record the DP's calls
    from inside it start here."""
    det._graphs.clear()


def capture_transposes(run, dtm, det) -> list:
    """The input pairs of every x-pass transpose of run() (the y pass's
    values and pointers, then the x pass's values and pointers), recorded
    through ops/distance_transform.py's transpose_last2_pair, with det's
    DP eager."""
    calls = []
    orig = dtm.transpose_last2_pair

    def record(x, y):
        calls.append((x, y))
        return orig(x, y)

    eager_dp(det)
    dtm.transpose_last2_pair = record
    try:
        run()
    finally:
        dtm.transpose_last2_pair = orig
    return calls


def count_dt_glue(torch, dt_cuda, dtm, det, im) -> None:
    """The device ops that the DT wrappers' own tensor code launches per
    person26 detect, counted by replaying one detect's arguments under
    the profiler: ops/dt_cuda.py::flatten_maps (the per-map parameters
    broadcast and made contiguous, once per 1-D pass) and the four
    negated slices of wdef in ops/distance_transform.py (once per 2-D
    DT), recorded from an eager DP."""
    import partsbaseddetector_tpu_torch.ops.dp as dp

    flat_calls, wdefs = [], []
    orig_flat, orig_dt = dt_cuda.flatten_maps, dp.shift_distance_transform_2d_packed

    def record_flat(*args):
        flat_calls.append(args)
        return orig_flat(*args)

    def record_dt(score, wdef, *args, **kwargs):
        wdefs.append(wdef)
        return orig_dt(score, wdef, *args, **kwargs)

    eager_dp(det)
    dt_cuda.flatten_maps, dp.shift_distance_transform_2d_packed = record_flat, record_dt
    try:
        det.detect(im)
    finally:
        dt_cuda.flatten_maps, dp.shift_distance_transform_2d_packed = orig_flat, orig_dt
    if not flat_calls or not wdefs:
        raise AssertionError("dt_glue: a detect ran no DT wrapper")
    flat = profiled(lambda: [orig_flat(*c) for c in flat_calls], 1)
    neg = profiled(lambda: [-w[..., k] for w in wdefs for k in range(4)], 1)
    log("dt_glue", flatten_maps_calls=len(flat_calls),
        flatten_maps_device_ops=f"{flat['ops']:.0f}",
        flatten_maps_device_ms=f"{flat['busy']:.4f}",
        dt2d_calls=len(wdefs), wdef_negation_device_ops=f"{neg['ops']:.0f}",
        wdef_negation_device_ms=f"{neg['busy']:.4f}")


def check_transpose(torch, np, tc, dtm, gen, det, im) -> dict:
    """T2 against transpose_last2_plain on the card, bit for bit, f32 and
    int32, single and as an (f32, i32) pair in one launch, at edge
    shapes, the DT x pass's person26 shapes, the Pallas probe's three
    shapes and more than 65,535 maps, and on every transpose pair of one
    person26 VGA detect and of one microbatch-8 program (maps of 8 images
    folded together); its gradient; at (80, 126, 166) f32 its time in
    turns with torch's transposed copy (the library call) and a
    contiguous copy of the same bytes; one pair launch against two single
    launches and two torch calls; and the summed device time of every
    transpose of one detect, kernel against torch."""
    dev = DEVICE

    def same(got, x, what):
        want = tc.transpose_last2_plain(x)
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(
                got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"transpose {what}: differs from plain")

    def exact_pair(x, y, what):
        xt, yt = tc.transpose_last2_pair(x, y)
        same(xt, x, f"pair {what}")
        same(yt, y, f"pair {what}")

    shapes = [(1, 1, 1), (3, 33, 31), (80, 126, 166), (80, 166, 126),
              (160, 168, 128), (160, 166, 126), (520, 128, 104), (7, 65, 130),
              (70000, 3, 2)]
    for shape in shapes:
        x = torch.randn(shape, generator=gen)
        x.view(-1)[::5] = -torch.inf
        y = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                          dtype=torch.int32)
        x, y = x.to(dev), y.to(dev)
        same(tc.transpose_last2(x), x, f"{shape} f32")
        same(tc.transpose_last2(y), y, f"{shape} i32")
        exact_pair(x, y, shape)
    empty = tc.transpose_last2_pair(torch.empty((0, 4, 5), device=dev),
                                    torch.empty((0, 4, 5), dtype=torch.int32, device=dev))
    if empty[0].shape != (0, 5, 4) or empty[1].shape != (0, 5, 4):
        raise AssertionError("transpose: empty pair has the wrong shape")
    caps = capture_transposes(lambda: det.detect(im), dtm, det)
    frames = [np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
              for i in range(8)]
    caps8 = capture_transposes(lambda: det.detect_many(frames, microbatch=8), dtm, det)
    for i, (cx, cy) in enumerate(caps + caps8):
        exact_pair(cx, cy, f"captured #{i} {tuple(cx.shape)}")
    if not caps or not caps8:
        raise AssertionError("transpose: a detect ran no x-pass transpose")
    maps = lambda cs: max(c.numel() // (c.shape[-2] * c.shape[-1]) for c, _ in cs)
    n8, most_maps = len(caps8), f"{maps(caps)} detect, {maps(caps8)} microbatch-8"
    del caps8
    x = torch.randn((80, 126, 166), generator=gen).to(dev).requires_grad_()
    y = torch.randint(0, 4096, (80, 126, 166), generator=gen, dtype=torch.int32).to(dev)
    cot = torch.randn((80, 166, 126), generator=gen).to(dev)
    (tc.transpose_last2(x) * cot).sum().backward()
    if not torch.equal(x.grad, tc.transpose_last2_plain(cot)):
        raise AssertionError("transpose: the gradient differs from the plain one")
    x.grad = None
    (tc.transpose_last2_pair(x, y)[0] * cot).sum().backward()
    if not torch.equal(x.grad, tc.transpose_last2_plain(cot)):
        raise AssertionError("transpose: the pair's gradient differs from the plain one")

    x = x.detach()
    dst = torch.empty_like(x)
    runs = {
        "kernel": lambda: tc.transpose_last2(x),
        "plain": lambda: tc.transpose_last2_plain(x),
        "copy": lambda: dst.copy_(x),
        "pair": lambda: tc.transpose_last2_pair(x, y),
        "two_singles": lambda: (tc.transpose_last2(x), tc.transpose_last2(y)),
        "two_plain": lambda: tc.transpose_last2_pair_plain(x, y),
    }
    # T2 launches per call of each run, which its device windows must hold
    t2 = {"kernel": 1, "pair": 1, "two_singles": 2}
    # in turns. Event times (the least of three) include the gaps between
    # launches, which at these sizes are the host's; device times (the
    # median of three) are the profiler's, kernels and copies only.
    event = {k: [] for k in runs}
    device = {k: [] for k in runs}
    for _ in range(3):
        for k, run in runs.items():
            event[k].append(cuda_ms(run, reps=50))
            device[k].append(device_ms(run, reps=50, launches={"transpose": t2.get(k, 0)}))
    event = {k: min(v) for k, v in event.items()}
    device = {k: statistics.median(v) for k, v in device.items()}
    ms, plain = event["kernel"], event["plain"]
    bnd = bound(2 * nbytes(x), 0.0)
    # one detect's transposes, device time from the profiler (events
    # around 100 launches would time the host's launch loop)
    det_ms = profiled(lambda: [tc.transpose_last2_pair(cx, cy) for cx, cy in caps],
        1)["busy"]
    det_plain = profiled(lambda: [tc.transpose_last2_pair_plain(cx, cy) for cx, cy in caps],
        1)["busy"]
    det_bound = bound(2 * nbytes(*(c for pair_ in caps for c in pair_)), 0.0)["bound_ms"]
    log("transpose", cases=3 * len(shapes) + 1, exact=True, gradient_exact=True,
        captured_exact=f"{len(caps)} detect + {n8} microbatch-8 pairs",
        most_maps_per_transpose=most_maps,
        shape="(80,126,166) f32", ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
        copy_ms=f"{event['copy']:.4f}",
        gb_per_s=f"{2 * nbytes(x) / ms / 1e6:.1f}",
        plain_gb_per_s=f"{2 * nbytes(x) / plain / 1e6:.1f}",
        bound_ms=f"{bnd['bound_ms']:.4f}", bound_by=bnd["bound_by"],
        pair_ms=f"{event['pair']:.4f}", two_singles_ms=f"{event['two_singles']:.4f}",
        two_plain_ms=f"{event['two_plain']:.4f}",
        **{f"{k}_device_ms": f"{v:.4f}" for k, v in device.items()},
        device_gb_per_s=f"{2 * nbytes(x) / device['kernel'] / 1e6:.1f}",
        per_detect_pair_launches=len(caps), per_detect_device_ms=f"{det_ms:.4f}",
        per_detect_plain_device_ms=f"{det_plain:.4f}",
        per_detect_bound_ms=f"{det_bound:.4f}")
    # the library call is torch's x.transpose(-1, -2).contiguous(), which
    # is also the plain version; event times as in every earlier run of
    # this script, the profiler's device times beside them
    return {"max_abs_err": 0.0, "ms": ms, "device_ms": device["kernel"],
            "plain_ms": plain, "plain_device_ms": device["plain"], **bnd,
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


def pyramid_batch_invariant(torch, np, frames) -> int:
    """The gate under the serving tolerance: person26's pyramid features
    (buckets_per_octave=2) of each frame alone equal theirs inside the
    batch of all of them, bit for bit. Returns the buckets compared."""
    from partsbaseddetector_tpu_torch import make_person_like_model
    from partsbaseddetector_tpu_torch.models.model import pack_model
    from partsbaseddetector_tpu_torch.ops import pyramid

    packed = pack_model(make_person_like_model())
    fh, fw = packed.filters.shape[1:3]
    plan = pyramid.build_plan(frames[0].shape[:2], packed.spec, fh, fw,
                              buckets_per_octave=2)
    batch = torch.as_tensor(np.stack(frames), device=DEVICE).float()
    together = pyramid.build_pyramid_features(batch, plan, packed.spec)
    for i in range(len(frames)):
        alone = pyramid.build_pyramid_features(batch[i : i + 1], plan, packed.spec)
        for b, (x, y) in enumerate(zip(alone, together)):
            if not torch.equal(x[0], y[i]):
                raise AssertionError(
                    f"serving: frame {i}'s bucket {b} features differ alone and "
                    f"in a batch of {len(frames)} (max {(x[0] - y[i]).abs().max().item():.3e})")
    return len(frames) * len(together)


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
    invariant = pyramid_batch_invariant(torch, np, frames[:8])

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
    p1 = profiled(lambda: det.detect_many(frames[:8]), 8)
    p8 = profiled(lambda: det.detect_many(frames[:8], microbatch=8), 8)
    log("serving", frames="64 distinct uint8 " + "x".join(map(str, im.shape[:2])),
        buckets_per_octave=2,
        candidates_frame0=len(want[0]), match_first_8="microbatch 8 and pipelined",
        pyramid_bit_identical_b1_b8=f"{invariant} (frame, bucket) pairs",
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


# the JAX package's visualize_model(make_person_like_model()) and
# hog_picture(<a 5x5 filter>) shapes (tests/test_torch_apps.py holds
# them to the JAX package's output)
PERSON26_MOSAIC_SHAPE = (600, 680)
HOG_GLYPH_SHAPE = (100, 100)
# a VGA camera's intrinsics (examples/conf/config_person.by_parts)
VGA_CAMERA = {"fx": 525.0, "fy": 525.0, "cx": 319.5, "cy": 239.5}
# the 3-D frames' depth: valid in a window this size around frame 0's
# top root box only (0, no return, elsewhere): the node's 3-D boxes keep
# x and y in pixels (as the JAX package's), so a box's crop takes every
# valid point of the frame, and the flood fill over a whole VGA cloud
# takes minutes a box
DEPTH_WINDOW = (32, 48)


def model_difference(np, a, b) -> str:
    """The first field in which two models differ ('' if none): every
    array bit for bit, the bias tables by value (the XML writer lays the
    bias pool out again)."""
    if (a.interval, a.sbin, a.thresh, a.ncomponents) != (
            b.interval, b.sbin, b.thresh, b.ncomponents):
        return "scalars"
    for key in ("filters", "defs", "anchors"):
        xs, ys = getattr(a, key), getattr(b, key)
        if len(xs) != len(ys) or not all(
                x.shape == y.shape and np.array_equal(x, y) for x, y in zip(xs, ys)):
            return key
    for c in range(a.ncomponents):
        if not np.array_equal(a.parentid[c], b.parentid[c]):
            return "parentid"
        for p in range(a.nparts(c)):
            for key in ("filterid", "defid"):
                if not np.array_equal(getattr(a, key)[c][p], getattr(b, key)[c][p]):
                    return key
            if not np.array_equal(a.biases[a.biasid[c][p]], b.biases[b.biasid[c][p]]):
                return "bias tables"
    return ""


def matched_within(a, b, score_tol, box_tol) -> bool:
    """Each candidate of a has its own candidate in b within the
    tolerances, taken best first: near-equal scores may swap places."""
    if len(a) != len(b):
        return False
    free = list(range(len(b)))
    for x in a:
        j = next((j for j in free if abs(x.score - b[j].score) < score_tol
                  and float(abs(x.parts - b[j].parts).max()) < box_tol), None)
        if j is None:
            return False
        free.remove(j)
    return True


@contextlib.contextmanager
def clocked_post_stages(stream_mod, timer):
    """Clock each post stage of the stream node (apps/stream.py's
    module-level names) into `timer`, restoring them after."""
    from partsbaseddetector_tpu_torch.types import Candidate
    from partsbaseddetector_tpu_torch.visualize import Visualize

    def clock(stage, fn):
        def run(*args, **kwargs):
            with timer.stage(stage):
                return fn(*args, **kwargs)
        return run

    class ClockedCandidate(Candidate):
        non_maxima_suppression = staticmethod(
            clock("nms", Candidate.non_maxima_suppression))
        mask = staticmethod(clock("mask", Candidate.mask))

    class ClockedVisualize(Visualize):
        def candidates(self, *args, **kwargs):
            with timer.stage("visualize"):
                return super().candidates(*args, **kwargs)

    patch = {"Candidate": ClockedCandidate, "Visualize": ClockedVisualize}
    for name, stage in (("compute_bounding_boxes", "boxes3d"), ("depth_to_cloud", "cloud"),
                        ("remove_planes", "remove_planes"),
                        ("cluster_objects", "clustering"), ("estimate_poses", "poses")):
        patch[name] = clock(stage, getattr(stream_mod, name))
    saved = {name: getattr(stream_mod, name) for name in patch}
    for name, fn in patch.items():
        setattr(stream_mod, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(stream_mod, name, fn)


def surfaces_files(np, pbd, model, im, work, card) -> str:
    """person26 written with the port's XML and .mat writers, read back
    by load_model: every array equal; a detect with the XML's model =
    the in-memory model's, bit for bit. Returns the XML's path."""
    from partsbaseddetector_tpu_torch.models import FileStorageModel, MatlabIOModel

    paths = {"xml": os.path.join(work, "person26.xml"),
             "mat": os.path.join(work, "person26.mat")}
    secs = {}
    for fmt, writer in (("xml", FileStorageModel), ("mat", MatlabIOModel)):
        t0 = time.perf_counter()
        writer.write(model, paths[fmt])
        secs[f"{fmt}_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = pbd.load_model(paths[fmt])
        secs[f"{fmt}_read_s"] = time.perf_counter() - t0
        diff = model_difference(np, model, loaded)
        if diff:
            raise AssertionError(f"surfaces: the {fmt} file loads with other {diff}")
    det = pbd.PartsBasedDetector(model, buckets_per_octave=2, device=DEVICE)
    det_xml = pbd.PartsBasedDetector(pbd.load_model(paths["xml"]),
                                     buckets_per_octave=2, device=DEVICE)
    want, got = det.detect(im), det_xml.detect(im)
    if not want or not same_candidates(got, want):
        raise AssertionError("surfaces: the .xml model's detect differs from the "
                             "in-memory model's: " + difference(got, want))
    log("surfaces_files", model="person26", arrays_equal="xml, mat",
        xml_bytes=os.path.getsize(paths["xml"]), mat_bytes=os.path.getsize(paths["mat"]),
        **{k: f"{v:.3f}" for k, v in secs.items()},
        xml_detect=f"{len(got)} candidates at " + "x".join(map(str, im.shape[:2]))
        + ", bit-identical", card=f"'{card}'")
    return paths["xml"]


def surfaces_stream(torch, np, pbd, dt_cuda, conv_cuda, tc, im, xml, card) -> tuple:
    """The ORK-shaped node from the .xml (apps.pipeline.build) serving 8
    RGB-D VGA frames through process_stream with the candidates topic:
    K1, K2 and T2 launched, each frame's candidates = sorted, NMS'd
    detect, bit for bit. Then all six topics on two frames whose depth
    is valid in a window only, each post stage clocked. Returns the
    node, the 8 frames and their results, the two 3-D frames and their
    results, and the kernels' launches over the 8 frames."""
    from partsbaseddetector_tpu_torch import depth as depth_mod
    from partsbaseddetector_tpu_torch import native
    from partsbaseddetector_tpu_torch.apps import pipeline as apps_pipeline
    from partsbaseddetector_tpu_torch.apps import stream as stream_mod
    from partsbaseddetector_tpu_torch.cloud import depth_to_cloud, euclidean_clusters
    from partsbaseddetector_tpu_torch.depth import StereoCameraModel
    from partsbaseddetector_tpu_torch.types import Candidate
    from partsbaseddetector_tpu_torch.utils.profiling import Timer

    rng = np.random.RandomState(10)
    frames = []
    for i in range(8):
        rgb = np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
        depth = ((1.0 + rng.rand(*im.shape[:2])) * 1000.0).astype(np.uint16)
        frames.append((rgb, depth))
    cfg = apps_pipeline.PipelineConfig(model_file=xml, camera=dict(VGA_CAMERA),
                                       max_overlap=0.1)
    node = apps_pipeline.build(cfg, device=DEVICE, buckets_per_octave=2)
    published = []
    node.subscribe("candidates", published.append)
    list(node.process_stream(frames[:2]))  # warm-up: the plan, the allocator
    published.clear()

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = list(fn())
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / len(frames)

    dt_cuda.launches = dt_cuda.aux_launches = conv_cuda.launches = tc.launches = 0
    results, node_ms = run(lambda: node.process_stream(frames))
    counts = {"dt1d": dt_cuda.launches, "dt1d_aux": dt_cuda.aux_launches,
              "conv": conv_cuda.launches, "transpose": tc.launches}
    if min(counts.values()) <= 0:
        raise AssertionError(f"surfaces: a kernel was not launched: {counts}")
    _, raw_ms = run(lambda: node.detector.detect_stream(frames))
    _, node_ms2 = run(lambda: node.process_stream(frames))
    _, raw_ms2 = run(lambda: node.detector.detect_stream(frames))
    if len(results) != 8 or published[:8] != [r.candidates for r in results]:
        raise AssertionError("surfaces: the candidates topic missed a frame")
    for i, (r, (rgb, depth)) in enumerate(zip(results, frames)):
        want = Candidate.non_maxima_suppression(
            rgb.shape[:2], Candidate.sort(node.detector.detect(rgb, depth)), 0.1)
        if not same_candidates(r.candidates, want):
            raise AssertionError(f"surfaces: frame {i}'s candidates differ from "
                                 "sorted, NMS'd detect: " + difference(r.candidates, want))
    if not results[0].candidates:
        raise AssertionError("surfaces: no candidates on frame 0")
    # the host depth filter inside detect_stream, on frame 0's detect:
    # its medians in NumPy (the port's depth.py) beside the native helper
    rgb0, depth0 = frames[0][0], frames[0][1].astype(np.float32) / 1000.0
    raw = node.detector.detect(rgb0)
    t0 = time.perf_counter()
    depth_mod.filter_candidates_by_depth(node.detector._packed, raw, depth0)
    filter_ms = (time.perf_counter() - t0) * 1e3
    boxes = np.array([c.parts[p] for c in raw for p in range(len(c.parts))])
    native.box_medians(depth0, boxes[:1])  # the build or load, and OpenMP's start
    t0 = time.perf_counter()
    med_np = depth_mod._batch_medians(depth0, list(boxes))
    np_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    med_native = native.box_medians(depth0, boxes)
    native_ms = (time.perf_counter() - t0) * 1e3
    log("surfaces_stream", frames="8 uint8 " + "x".join(map(str, im.shape[:2]))
        + " with uint16 depth (mm)", source="apps.pipeline.build(.xml)",
        max_overlap=0.1, buckets_per_octave=2, topics="candidates",
        candidates=",".join(str(len(r.candidates)) for r in results),
        equal_to_sorted_nms_detect=True,
        launches=",".join(f"{k}:{v}" for k, v in counts.items()),
        process_stream_ms_per_frame=f"{node_ms:.3f},{node_ms2:.3f}",
        detect_stream_ms_per_frame=f"{raw_ms:.3f},{raw_ms2:.3f}",
        depth_filter_ms=f"{filter_ms:.1f} ({len(raw)} candidates, {len(boxes)} boxes)",
        medians_numpy_ms=f"{np_ms:.1f}", medians_native_ms=f"{native_ms:.1f}",
        medians_equal=bool(np.array_equal(med_np, med_native)), card=f"'{card}'")

    # all six topics on frames 0 and 1, their depth valid in a window
    root = results[0].candidates[0].parts[0]
    wy, wx = DEPTH_WINDOW
    cy = int(min(max((root[1] + root[3]) / 2 - wy / 2, 0), im.shape[0] - wy))
    cx = int(min(max((root[0] + root[2]) / 2 - wx / 2, 0), im.shape[1] - wx))
    frames3d = []
    for rgb, depth in frames[:2]:
        windowed = np.zeros_like(depth)
        windowed[cy:cy + wy, cx:cx + wx] = depth[cy:cy + wy, cx:cx + wx]
        frames3d.append((rgb, windowed))
    for topic in ("image", "mask", "bbox3d", "clusters", "poses"):
        node.subscribe(topic, lambda payload: None)
    timer = Timer()
    with clocked_post_stages(stream_mod, timer):
        t0 = time.perf_counter()
        res3d = list(node.process_stream(frames3d))
        post_wall = time.perf_counter() - t0
    nfinite = nclusters = 0
    for i, (r, (rgb, depth)) in enumerate(zip(res3d, frames3d)):
        want = Candidate.non_maxima_suppression(
            rgb.shape[:2], Candidate.sort(node.detector.detect(rgb, depth)), 0.1)
        if not same_candidates(r.candidates, want):
            raise AssertionError(f"surfaces: 3-D frame {i}'s candidates differ: "
                                 + difference(r.candidates, want))
        n = len(r.candidates)
        if (r.image_rgb is None or r.image_rgb.shape != rgb.shape
                or r.mask is None or r.mask.shape != rgb.shape[:2]
                or not (len(r.boxes3d) == len(r.clusters) == len(r.poses) == n)):
            raise AssertionError(f"surfaces: 3-D frame {i}: a topic's output is missing")
        for box, cl, pose in zip(r.boxes3d, r.clusters, r.poses):
            vals = np.array([box.x, box.y, box.z, box.width, box.height, box.depth])
            no_depth = np.isnan(box.z) and not vals[3:].any()
            if not (np.isfinite(vals).all() or no_depth):
                raise AssertionError(f"surfaces: a 3-D box is not finite: {box}")
            if not np.isfinite(cl).all() or not np.isfinite(pose[:3, :3]).all() or (
                    len(cl) and not np.isfinite(pose).all()):
                raise AssertionError("surfaces: a cluster or pose is not finite")
            nfinite += int(not no_depth)
            nclusters += int(len(cl) > 0)
    if not np.isfinite(res3d[0].boxes3d[0].z):
        raise AssertionError("surfaces: frame 0's top box has no 3-D box")
    stage_s = {k: sum(v) / len(frames3d) for k, v in timer.times.items()}
    # one flood fill over 20,000 points of frame 0's whole cloud: the
    # cost per point of a crop that takes the whole cloud
    cam = StereoCameraModel(**VGA_CAMERA)
    cloud = depth_to_cloud(frames[0][1].astype(np.float32) / 1000.0, cam)
    npts = min(20000, len(cloud))
    sample = cloud[np.random.RandomState(11).choice(len(cloud), npts, replace=False)]
    t0 = time.perf_counter()
    nsample = len(euclidean_clusters(sample))
    flood_s = time.perf_counter() - t0
    log("surfaces_post", frames=2, topics="candidates,image,mask,bbox3d,clusters,poses",
        depth_window="x".join(map(str, DEPTH_WINDOW)),
        candidates=",".join(str(len(r.candidates)) for r in res3d),
        finite_3d_boxes=nfinite, nonempty_clusters=nclusters,
        remove_planes="not used", wall_s_per_frame=f"{post_wall / len(frames3d):.3f}",
        **{f"{k}_s_per_frame": f"{v:.4f}" for k, v in stage_s.items()},
        flood_fill_points=npts, flood_fill_s=f"{flood_s:.3f}",
        flood_fill_clusters=nsample,
        card=f"'{card}'")
    return node, frames, results, res3d, frames3d, counts


def surfaces_messages_eval(np, pbd, model, node, frames, res3d, frames3d, card) -> None:
    """apps.messages from frame 0's 3-D result; eval.test_model on the
    card with ground truth from the CPU path's best candidates at
    120x160 (PCK 1.0 at every part); visualize_model and hog_picture at
    the JAX package's shapes; Visualize on the card's and the CPU's
    candidates gives equal canvases."""
    from partsbaseddetector_tpu_torch import Visualize
    from partsbaseddetector_tpu_torch import visualize_model as vm
    from partsbaseddetector_tpu_torch.apps import messages
    from partsbaseddetector_tpu_torch.cloud import compute_bounding_boxes
    from partsbaseddetector_tpu_torch.depth import StereoCameraModel
    from partsbaseddetector_tpu_torch.eval import metrics
    from partsbaseddetector_tpu_torch.ops.nms import part_nms

    r0, (rgb0, d0) = res3d[0], frames3d[0]
    n = len(r0.candidates)
    name = node.detector.name
    cubes = messages.message_bounding_boxes(r0.boxes3d, object_name=name)
    image = messages.message_image_rgb(rgb0, r0.candidates, name)
    mask = messages.message_mask(rgb0.shape[:2], r0.candidates)
    cloud = messages.message_clusters(r0.clusters)
    centroids = [c.mean(axis=0) if len(c) else np.full(3, np.nan) for c in r0.clusters]
    _, centers = compute_bounding_boxes(r0.candidates, rgb0.shape[:2],
                                        d0.astype(np.float32) / 1000.0,
                                        StereoCameraModel(**VGA_CAMERA))
    poses = messages.message_poses(centroids, centers)
    if (len(cubes) != n or len(poses["poses"]) != n
            or len(r0.pose_results(name)) != n
            or len(cloud["points"]) != sum(len(c) for c in r0.clusters)
            or not set(np.unique(mask["data"])) <= set(range(n + 1))
            or not np.array_equal(image["data"], r0.image_rgb)
            or not all(np.array_equal(p["matrix"], q, equal_nan=True)
                       for p, q in zip(poses["poses"], r0.poses))):
        raise AssertionError("surfaces: the messages disagree with frame 0's result")

    cpu = pbd.PartsBasedDetector(model, buckets_per_octave=2, device="cpu")
    smalls, gts, cpu_cands = [], [], []
    for rgb, _ in frames[:4]:
        small = rgb[:120, :160]
        cands = cpu.detect(small)
        if not cands:
            continue
        boxes = np.stack([c.parts for c in cands])
        best = cands[int(part_nms(boxes, np.array([c.score for c in cands]), 0.3)[0])]
        smalls.append(small)
        cpu_cands.append(cands)
        gts.append(metrics.boxes_to_keypoints(best.parts)[None])
    if not smalls:
        raise AssertionError("surfaces: the CPU path found nothing at 120x160")
    pck = metrics.test_model(node.detector, smalls, gts)
    if not (pck == 1.0).all():
        raise AssertionError(f"surfaces: PCK against the CPU path {pck}")
    mosaic, glyph = vm.visualize_model(model), vm.hog_picture(model.filters[0])
    if (mosaic.shape != PERSON26_MOSAIC_SHAPE or glyph.shape != HOG_GLYPH_SHAPE
            or not mosaic.max() or not glyph.max()):
        raise AssertionError(f"surfaces: model pictures {mosaic.shape}, {glyph.shape}")
    vis = Visualize(name)
    for small, want in zip(smalls, cpu_cands):
        if not np.array_equal(vis.candidates(small, node.detector.detect(small)),
                              vis.candidates(small, want)):
            raise AssertionError("surfaces: the card's and the CPU's canvases differ")
    log("surfaces_messages_eval", cubes=len(cubes), poses=len(poses["poses"]),
        cloud_points=len(cloud["points"]), mask_labels=int(mask["data"].max()),
        eval_frames=f"{len(smalls)} at 120x160", pck=",".join(f"{v:g}" for v in pck[:3])
        + f",... ({len(pck)} parts)", model_mosaic="x".join(map(str, mosaic.shape)),
        canvases_card_eq_cpu=len(smalls), card=f"'{card}'")


def cut_at_gap(model, scores, lo=20, hi=40):
    """A copy of the model whose threshold keeps lo-hi of these
    best-first scores: halfway across the widest gap between two
    neighbours there, so that rounding cannot move a candidate across."""
    import copy

    if len(scores) < 2:
        raise AssertionError(f"surfaces: {len(scores)} candidates to cut")
    k = max(range(min(lo, len(scores) - 1), min(hi, len(scores) - 1) + 1),
            key=lambda i: scores[i - 1] - scores[i])
    cut = copy.deepcopy(model)
    cut.thresh = (scores[k - 1] + scores[k]) / 2
    return cut, k


def surfaces_cpu_detector(torch, np, pbd, model, frames, card) -> None:
    """CPUPartsBasedDetector on the port's native kernels, built here,
    against the card detector on frame 0's 120x160 corner: gated on
    tests/test_cpu_detector.py's own model at the tolerance that test
    holds the JAX pair to (|dscore| < 2e-3, parts within 5e-2), its
    threshold cut to keep 20-40 candidates. person26 is timed and its
    largest score difference printed, not gated: at candidates that
    cross the image border the reference pipeline and the detector can
    differ by more than 2e-3 on person26, in the JAX package as well."""
    from partsbaseddetector_tpu_torch import CPUPartsBasedDetector, native
    from partsbaseddetector_tpu_torch.types import Candidate

    if not native.available():
        raise AssertionError("surfaces: the native library did not build")
    small = frames[0][0][:120, :160]
    m4 = pbd.make_synthetic_model(nparts=4, nmix=2, fsize=(4, 4), sbin=8, interval=2,
                                  thresh=1.0, seed=40)
    scores = [c.score for c in Candidate.sort(CPUPartsBasedDetector(m4).detect(small))]
    m4, k4 = cut_at_gap(m4, scores)
    want4 = Candidate.sort(CPUPartsBasedDetector(m4).detect(small))
    got4 = pbd.PartsBasedDetector(m4, max_detections=512, device=DEVICE).detect(small)
    if len(want4) != k4 or not matched_within(want4, got4, 2e-3, 5e-2):
        raise AssertionError("surfaces: the CPU detector differs from the card's: "
                             + difference(got4, want4))

    scores = [c.score for c in Candidate.sort(CPUPartsBasedDetector(model).detect(small))]
    cut, k = cut_at_gap(model, scores)
    cpu = CPUPartsBasedDetector(cut)
    cpu_ms, want = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        want = Candidate.sort(cpu.detect(small))
        cpu_ms.append((time.perf_counter() - t0) * 1e3)
    det = pbd.PartsBasedDetector(cut, max_detections=512, device=DEVICE)
    got = det.detect(small)
    card_ms = [timed_detect(torch, det, small) for _ in range(3)]
    dmax = max(abs(x.score - y.score) for x, y in zip(Candidate.sort(got), want))
    log("surfaces_cpu_detector", kernels="native (g++ -O3 -march=native -fopenmp)",
        imsize="120x160", model4_candidates=f"{len(want4)} matched within 2e-3 / 5e-2",
        person26_candidates=f"cpu {len(want)}, card {len(got)}",
        person26_max_dscore_best_first=f"{dmax:.3e}",
        cpu_ms_per_image=",".join(f"{t:.1f}" for t in cpu_ms),
        card_ms_per_image=",".join(f"{t:.3f}" for t in card_ms), card=f"'{card}'")


def surfaces_config_demo(np, pbd, frames, frame0, xml, work, have_yaml, have_pil,
                         card) -> None:
    """With PyYAML: build_from_file on examples/conf/config_person.by_parts
    pointed at the .xml gives the node's frame 0 candidates. With PIL:
    apps.demo.main on a PNG and its uint16 depth PNG."""
    from partsbaseddetector_tpu_torch.apps import demo
    from partsbaseddetector_tpu_torch.apps import pipeline as apps_pipeline
    from partsbaseddetector_tpu_torch.types import Candidate

    fields = {"yaml": have_yaml, "pil": have_pil}
    if have_yaml:
        text = (ROOT / "examples" / "conf" / "config_person.by_parts").read_text()
        if '"/tmp/person26.npz"' not in text:
            raise AssertionError("surfaces: config_person.by_parts names another model")
        cpath = os.path.join(work, "config_person.by_parts")
        with open(cpath, "w") as fh:
            fh.write(text.replace('"/tmp/person26.npz"', f'"{xml}"'))
        node2 = apps_pipeline.build_from_file(cpath, device=DEVICE, buckets_per_octave=2)
        r = next(node2.process_stream(frames[:1]))
        if not same_candidates(r.candidates, frame0) or r.image_rgb is None:
            raise AssertionError("surfaces: build_from_file's node differs")
        fields["config_node_candidates"] = len(r.candidates)
    if have_pil:
        import io

        from PIL import Image

        rgb, depth = frames[0]
        png, dpng, out = (os.path.join(work, f) for f in ("f0.png", "d0.png", "demo.png"))
        Image.fromarray(rgb).save(png)
        Image.fromarray(depth).save(dpng)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = demo.main([xml, png, dpng, "--out", out, "--nms", "0.1",
                            "--device", DEVICE])
        det = pbd.PartsBasedDetector(pbd.load_model(xml), device=DEVICE)
        im = rgb.astype(np.float32)
        want = Candidate.non_maxima_suppression(
            im.shape[:2], Candidate.sort(det.detect(im, depth.astype(np.float32) / 1000.0)),
            0.1)
        if rc != 0 or not os.path.exists(out) or not buf.getvalue().startswith(
                f"{len(want)} candidates"):
            raise AssertionError(f"surfaces: the demo failed: {buf.getvalue()[:200]}")
        fields["demo_candidates"] = len(want)
    log("surfaces_config_demo", **fields, card=f"'{card}'")


def check_surfaces(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card, have_yaml,
                   have_pil) -> dict:
    """The surfaces on person26 at VGA, f32, buckets_per_octave=2: the
    model files, the stream node and its post stages, messages, eval,
    visualization, the CPU detector, and (with PyYAML and PIL) the
    config file and the demo. Returns the kernels' launches over the
    node's 8 frames."""
    import tempfile

    t0 = time.perf_counter()
    model = pbd.make_person_like_model()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        xml = surfaces_files(np, pbd, model, im, work, card)
        node, frames, results, res3d, frames3d, counts = surfaces_stream(
            torch, np, pbd, dt_cuda, conv_cuda, tc, im, xml, card)
        surfaces_messages_eval(np, pbd, model, node, frames, res3d, frames3d, card)
        surfaces_cpu_detector(torch, np, pbd, model, frames, card)
        surfaces_config_demo(np, pbd, frames, results[0].candidates, xml, work,
                             have_yaml, have_pil, card)
    log("surfaces", seconds=f"{time.perf_counter() - t0:.1f}", card=f"'{card}'")
    return counts


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
        raise AssertionError("nms: CUDA and CPU paths differ at 120x160: "
                             + difference(got, want))
    frames = np.stack([np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
                       for i in range(8)])
    boxes, scores, _, valid, _ = plain.detect_batch_fn(im.shape[:2], 8)(
        torch.as_tensor(frames, device=DEVICE))
    per_image, busy = {}, {}
    for b in (1, 8):
        args = (boxes[:b], scores[:b], valid[:b], 0.3)
        per_image[b] = cuda_ms(lambda: nms.part_nms_device(*args), reps=5) / b
        busy[b] = profiled(lambda: nms.part_nms_device(*args), b)

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
    (one 3xTF32 core, csrc/conv_core.cuh); ms at each toh beside K2,
    conv2d and the plain version, in turns; then one run of the harness
    itself, `python -m partsbaseddetector_tpu_torch.tools.conv_proto`,
    whose launch count is the row's; the row's device time is T1's at
    toh 2 in this process."""
    dev = DEVICE
    s, f, h, w = 5, 104, 126, 166
    feat_np, filt_np = harness.seeded_inputs(s, h, w, f)
    feat = torch.as_tensor(feat_np, device=dev)
    filt = torch.as_tensor(filt_np, device=dev)
    feat_t = feat.permute(0, 1, 3, 2).contiguous()
    w2 = cp.weights_k_major(filt)
    want = cp.conv_proto_plain(feat_t, w2, f)
    scale = cp.conv_proto_plain(feat_t.abs(), w2.abs(), f)
    bank = conv_cuda.split_bank(filt)
    run_k2 = lambda: conv_cuda.filter_responses_grouped([feat], filt, bank)[0]
    k2 = run_k2()
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
        k2_ms.append(cuda_ms(run_k2, reps=20))
        lib_ms.append(cuda_ms(lambda: conv2d(x_nchw, w_nchw), reps=20))
        plain_ms.append(cuda_ms(lambda: cp.conv_proto_plain(feat_t, w2, f), reps=5))
    ms = {t: min(v) for t, v in ms.items()}
    k2_ms, lib_ms, plain_ms = min(k2_ms), min(lib_ms), min(plain_ms)
    _, oh, ow, _ = want.shape
    ops = 2.0 * s * oh * ow * cp.FH * cp.FW * cp.C * f
    bnd = conv_bound(nbytes(feat_t, w2, want), ops)

    proc = subprocess.run(
        [sys.executable, "-m", "partsbaseddetector_tpu_torch.tools.conv_proto"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise AssertionError(f"conv_proto harness failed:\n{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if not res.get("equal_to_k2") or res.get("launches") != 1:
        raise AssertionError(f"conv_proto harness: {res}")
    # the kernel's device time at toh 2 in this process, from windows that
    # recorded every launch; the harness's own process's beside it
    dms = device_ms(lambda: cp.conv_proto(feat_t, w2, f, 2), reps=20,
                    launches={"conv": 1})
    tflops = lambda t: ops / t / 1e9
    log("conv_proto", shape="(5,126,166,32)x(104,5,5,32)", seed="RandomState(0)",
        equal_to_k2="bit for bit at toh 1,2,4,8",
        max_abs_err=",".join(f"{t}:{e:.3e}" for t, e in errs.items()),
        bound="1e-5*sum|x*w|",
        ms_by_toh=",".join(f"{t}:{v:.4f}" for t, v in ms.items()),
        tflops_by_toh=",".join(f"{t}:{tflops(v):.2f}" for t, v in ms.items()),
        k2_ms=f"{k2_ms:.4f}", library_conv2d_ms=f"{lib_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bnd['bound_ms']:.4f}",
        bound_by=bnd["bound_by"], fp32_bound_ms=f"{bnd['fp32_bound_ms']:.4f}",
        toh2_device_ms=f"{dms:.4f}", gflop=f"{ops / 1e9:.3f}",
        harness=f"rc 0, toh 2 {res['ms']:.4f} ms, device {res['device_ms']:.4f} ms, "
                f"K2 {res['k2_ms']:.4f} ms, conv2d {res['conv2d_ms']:.4f} ms")
    return {"launches": res["launches"], "max_abs_err": max(errs.values()),
            "ms": ms[2], "device_ms": dms, "ms_by_toh": ms, "k2_ms": k2_ms,
            "plain_ms": plain_ms, **bnd, "library_ms": lib_ms}


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
    2e-5, parts 1e-4); a profile, and the re-score stage's time by CUDA
    events alone on the inputs a detect gave it: it launches torch's
    kernels only, with no counter to hold a profiler window to, and late
    in the process torch.profiler drops such windows' records (PERF.md
    §6)."""
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
        raise AssertionError("hybrid: CUDA and CPU paths differ at 120x160: "
                             + difference(got, want))
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

    prof = profiled(lambda: [hdet.detect(im) for _ in range(3)], 3)
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
    stage_ms = cuda_ms(lambda: orig(*args, **kwargs), reps=5)
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
        rescore_event_ms=f"{stage_ms:.4f}",
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


def require_counts(phase: str, counts: dict, launched=(), zero=()) -> None:
    """Fail the phase unless every kernel in `launched` ran at least
    once and none in `zero` ran."""
    if any(counts[k] <= 0 for k in launched) or any(counts[k] for k in zero):
        raise AssertionError(f"{phase}: launches {counts}, wanted >0 for "
                             f"{list(launched)} and 0 for {list(zero)}")


def vga_frames(np, im, n: int):
    """n distinct uint8 frames: the VGA frame shifted by 0..n-1 grey
    levels (config 4's frames)."""
    return [np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8) for i in range(n)]


def check_parallel(torch, np, pbd, pbd_train, dt_cuda, conv_cuda, tc, im, card) -> dict:
    """parallel/ at world size 1 over NCCL (one card: NCCL refuses two
    ranks on one GPU; several ranks are rehearsed as gloo runs in
    tests/test_torch_parallel.py). The NCCL set-up seconds (the mesh and
    the first collective); person26 at 480x640, buckets_per_octave=2,
    microbatch 8 over 8 frames, both engines: batched_detect_fn's
    gathered outputs equal detect_batch_fn's bit for bit, K1, K3 and T2
    (and K2 for the spatial engine) launched, ms/image of both in turns
    (medians of 5); then sharded_train_step on the train phase's batch
    (8 at 240x320, non-latent as the JAX sharded step) for two steps in
    turns with make_train_step: loss and pools within rtol 1e-4,
    atol 1e-5, K1 and K4 launched, ms/step of both. Any collective
    failure raises."""
    import torch.distributed as dist

    from partsbaseddetector_tpu_torch import parallel
    from partsbaseddetector_tpu_torch.models import pack_model

    t0 = time.perf_counter()
    mesh = parallel.make_mesh(device=DEVICE)
    probe = torch.ones(1, device=DEVICE)
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    backend = dist.get_backend()
    try:
        if float(probe) != 1.0 or mesh.shape != (1, 1):
            raise AssertionError(f"parallel: world-1 all_reduce gave {float(probe)}")
        model = pbd.make_person_like_model()
        imsize = tuple(im.shape[:2])
        frames = torch.as_tensor(np.stack(vga_frames(np, im, 8)), device=DEVICE)
        out = {"setup_s": setup_s}
        for engine in ("spatial", "fourier"):
            det = pbd.PartsBasedDetector(model, buckets_per_octave=2,
                                         conv_engine=engine, device=DEVICE)
            fn = parallel.batched_detect_fn(det, imsize, mesh)
            batch_fn = det.detect_batch_fn(imsize, 8)
            want = batch_fn(frames)  # warm-up: plan, allocator
            fn(frames)
            torch.cuda.synchronize()
            zero_counts(dt_cuda, conv_cuda, tc)
            got = fn(frames)
            torch.cuda.synchronize()
            counts = mine_counts(dt_cuda, conv_cuda, tc)
            require_counts(f"parallel_{engine}", counts,
                             ("dt1d", "dt1d_aux", "transpose")
                             + (("conv",) if engine == "spatial" else ()))
            for g, w in zip(got, want):
                if not torch.equal(g.full_tensor(), w):
                    raise AssertionError(f"parallel: {engine} batched detect differs "
                                         "from detect_batch_fn")
            par, one = [], []
            for _ in range(5):
                par.append(timed_run(torch, lambda: fn(frames))[1] * 1e3 / 8)
                one.append(timed_run(torch, lambda: batch_fn(frames))[1] * 1e3 / 8)
            out[engine] = {"counts": counts, "ms": statistics.median(par),
                           "plain_ms": statistics.median(one)}
            log(f"parallel_{engine}", world=1, backend=backend, mesh="1x1",
                nccl_setup_s=f"{setup_s:.3f}", frames="8 uint8 VGA", microbatch=8,
                equal_to_detect_batch_fn=True,
                launches=",".join(f"{k}:{v}" for k, v in counts.items()),
                ms_per_image_median=f"{out[engine]['ms']:.3f}",
                detect_batch_fn_ms_per_image_median=f"{out[engine]['plain_ms']:.3f}",
                ms_all=",".join(f"{t:.3f}" for t in par),
                detect_batch_fn_ms_all=",".join(f"{t:.3f}" for t in one), card=f"'{card}'")

        packed = pack_model(model)
        timsize, tbatch = TRAIN_BATCH
        rng = np.random.RandomState(0)
        imgs = torch.as_tensor((rng.rand(tbatch, *timsize, 3) * 255.0).astype(np.float32),
                               device=DEVICE)
        labels = np.array([1.0, -1.0] * (tbatch // 2), np.float32)
        step, make_opt, shard = parallel.sharded_train_step(packed, timsize, mesh)
        ref_step, ref_opt = pbd_train.make_train_step(packed, timsize)
        params = shard(pbd_train.model_params(model, DEVICE))
        opt = make_opt(params.values())
        ref = pbd_train.model_params(model, DEVICE)
        ropt = ref_opt(ref.values())
        zero_counts(dt_cuda, conv_cuda, tc)
        dt_cuda.bwd_launches = 0
        tcounts = {"dt1d": 0, "dt1d_bwd": 0, "conv": 0}
        losses, rlosses, secs, rsecs = [], [], [], []
        for _ in range(2):
            (_, _, rl), rs = timed_run(torch, lambda: ref_step(ref, ropt, imgs, labels))
            before = (dt_cuda.launches, dt_cuda.bwd_launches, conv_cuda.launches)
            (_, _, loss), ss = timed_run(torch, lambda: step(params, opt, imgs, labels))
            for k, b, a in zip(tcounts, before, (dt_cuda.launches, dt_cuda.bwd_launches,
                                                 conv_cuda.launches)):
                tcounts[k] += a - b
            losses.append(float(loss))
            rlosses.append(float(rl))
            secs.append(ss)
            rsecs.append(rs)
        require_counts("parallel_train", tcounts, ("dt1d", "dt1d_bwd"))
        for a, b in zip(losses, rlosses):
            if abs(a - b) > TRAIN_TOL["rtol"] * abs(b) or not math.isfinite(a):
                raise AssertionError(f"parallel_train: loss {a} against {b}")
        worst = {}
        for k, v in shard.gather(params).items():
            y = ref[k].detach()
            err = (v - y).abs()
            lim = TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * y.abs()
            worst[k] = (err / lim).max().item()
            if not bool((err <= lim).all()):
                raise AssertionError(f"parallel_train: pools differ in {k} (x{worst[k]:.3g})")
        out["train"] = {"counts": tcounts, "ms": statistics.median(secs) * 1e3,
                        "plain_ms": statistics.median(rsecs) * 1e3}
        log("parallel_train", world=1, backend=backend, mesh="1x1", model="person26",
            imsize="x".join(map(str, timsize)), batch=tbatch, steps=2, latent=False,
            launches=",".join(f"{k}:{v}" for k, v in tcounts.items()),
            losses=",".join(f"{x:.6f}" for x in losses),
            make_train_step_losses=",".join(f"{x:.6f}" for x in rlosses),
            max_err_over_bound=",".join(f"{k}:{v:.3g}" for k, v in worst.items()),
            ms_per_step=",".join(f"{t * 1e3:.3f}" for t in secs),
            make_train_step_ms_per_step=",".join(f"{t * 1e3:.3f}" for t in rsecs),
            card=f"'{card}'")
        return out
    finally:
        dist.destroy_process_group()


def check_bf16_plain(torch, np, pbd, dt_cuda, conv_cuda, tc, det, im, card) -> dict:
    """bf16 without the f32 re-rank on person26 VGA, buckets_per_octave=2:
    K1, K3 and T2 launched and K2 not (the conv is cuDNN's bf16 conv2d,
    the JAX package's lax.conv), deterministic, ms/image in turns with
    the f32 detector `det` and the hybrid (medians of 7); the bf16
    pyramid of 8 frames alone and in one batch bit-identical; the CPU
    path's candidates at 120x160 (thresh -1e9, 32 detections) matched by
    box (bench.py's _match_boxes, 0.75 px): at least 80% of them, scores
    within 0.05; microbatch-8 images/s over 32 frames."""
    from partsbaseddetector_tpu_torch.models.model import pack_model
    from partsbaseddetector_tpu_torch.ops import pyramid

    bf16 = torch.bfloat16
    model = pbd.make_person_like_model()
    kw = dict(buckets_per_octave=2, device=DEVICE)
    pdet = pbd.PartsBasedDetector(model, dtype=bf16, rerank_fp32=False, **kw)
    hdet = pbd.PartsBasedDetector(model, dtype=bf16, **kw)
    pdet.detect(im)  # warm-up: plan, allocator
    hdet.detect(im)
    zero_counts(dt_cuda, conv_cuda, tc)
    first = pdet.detect(im)
    torch.cuda.synchronize()
    counts = mine_counts(dt_cuda, conv_cuda, tc)
    require_counts("bf16_plain", counts, ("dt1d", "dt1d_aux", "transpose"), ("conv",))
    if not first or not all(np.isfinite(c.score) and np.isfinite(c.parts).all()
                            and c.parts.shape == (26, 4) for c in first):
        raise AssertionError("bf16_plain: no candidates, or malformed ones")
    if not same_candidates(first, pdet.detect(im)):
        raise AssertionError("bf16_plain: two runs differ")
    plain, hy, f32 = [], [], []
    for _ in range(7):
        f32.append(timed_detect(torch, det, im))
        hy.append(timed_detect(torch, hdet, im))
        plain.append(timed_detect(torch, pdet, im))

    frames = vga_frames(np, im, 32)
    packed = pack_model(model)
    fh, fw = packed.filters.shape[1:3]
    plan = pyramid.build_plan(im.shape[:2], packed.spec, fh, fw, buckets_per_octave=2)
    batch = torch.as_tensor(np.stack(frames[:8]), device=DEVICE).to(bf16)
    together = pyramid.build_pyramid_features(batch, plan, packed.spec)
    for i in (0, 7):
        alone = pyramid.build_pyramid_features(batch[i : i + 1], plan, packed.spec)
        if not all(torch.equal(x[0], y[i]) for x, y in zip(alone, together)):
            raise AssertionError(f"bf16_plain: frame {i}'s bf16 features differ alone "
                                 "and in a batch of 8")

    lo = pbd.make_person_like_model()
    lo.thresh = -1e9
    small = im[:120, :160]
    kws = dict(max_detections=32, buckets_per_octave=2, dtype=bf16, rerank_fp32=False)
    got = pbd.PartsBasedDetector(lo, device=DEVICE, **kws).detect_dense(small)
    want = pbd.PartsBasedDetector(lo, device="cpu", **kws).detect_dense(small)
    nq, nm, dmax = match_boxes(want.boxes, want.scores, want.valid,
                               got.boxes, got.scores, got.valid)
    if nm < max(1, int(0.8 * nq)) or dmax > 0.05:
        raise AssertionError(f"bf16_plain: CPU match at 120x160 {nm}/{nq}, max dscore {dmax}")

    pdet.detect_many(frames[:8], microbatch=8)  # warm-up
    ips = [32 / timed_run(torch, lambda: pdet.detect_many(frames, microbatch=8))[1]
           for _ in range(2)]
    ms = statistics.median(plain)
    log("bf16_plain", imsize="x".join(map(str, im.shape[:2])), buckets_per_octave=2,
        dtype="bfloat16", rerank_fp32=False, candidates=len(first),
        top_score=f"{first[0].score:.4f}", deterministic=True,
        launches=",".join(f"{k}:{v}" for k, v in counts.items()),
        ms_per_image_median=f"{ms:.3f}",
        hybrid_ms_per_image_median=f"{statistics.median(hy):.3f}",
        f32_ms_per_image_median=f"{statistics.median(f32):.3f}",
        ms_all=",".join(f"{t:.3f}" for t in plain),
        pyramid_batch_invariant_b1_b8=True,
        cpu_match_120x160=f"{nm}/{nq} by box, max dscore {dmax:.3e}",
        microbatch8_images_per_s=",".join(f"{t:.3f}" for t in ips), card=f"'{card}'")
    return {"counts": counts, "ms": ms}


def root_key(d) -> tuple:
    """A mined placement's root: level, component and the root's grid
    coordinates (a 26-part placement's other parts and mixtures sit on
    bf16 score plateaus: at person26's scores, about 33, bf16 spacing is
    0.25)."""
    return (d["level"], d["component"], int(d["xs"][0]), int(d["ys"][0]))


def check_bf16_mine(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card) -> dict:
    """TPUMiner(dtype=bfloat16) on person26 at MINE_IMSIZE, max_det 64:
    K1, K3 and T2 launched and K2 not, deterministic; its root
    placements (root_key) against the f32 miner's: the f32 top-1's root
    among them and at least a quarter shared (36 of 64 on the CPU at
    120x160); the CPU bf16 miner's at 120x160: at least 80% shared, and
    the whole placements shared reported; ms per mine of both miners in
    turns (medians of 5)."""
    from partsbaseddetector_tpu_torch.train.detect_tpu import TPUMiner

    model = pbd.make_person_like_model()
    frame = np.ascontiguousarray(im[: MINE_IMSIZE[0], : MINE_IMSIZE[1]])
    m16 = TPUMiner(model, max_det=64, dtype=torch.bfloat16, device=DEVICE)
    m32 = TPUMiner(model, max_det=64, device=DEVICE)
    timed_mine(torch, m16, frame)  # warm-up: plans, pools
    timed_mine(torch, m32, frame)
    zero_counts(dt_cuda, conv_cuda, tc)
    d16, _ = timed_mine(torch, m16, frame)
    counts = mine_counts(dt_cuda, conv_cuda, tc)
    require_counts("bf16_mine", counts, ("dt1d", "dt1d_aux", "transpose"), ("conv",))
    if not d16 or not same_placements(np, d16, timed_mine(torch, m16, frame)[0]):
        raise AssertionError("bf16_mine: no placements, or two mines differ")
    t16, t32 = [], []
    for _ in range(5):
        t32.append(timed_mine(torch, m32, frame)[1])
        t16.append(timed_mine(torch, m16, frame)[1])
    d32 = m32.detect(frame, thresh=-1e8)
    k16 = {root_key(d) for d in d16}
    shared = len(k16 & {root_key(d) for d in d32})
    top1 = root_key(d32[0]) in k16
    if not top1 or shared < len(d32) // 4:
        raise AssertionError(f"bf16_mine: f32 top-1 found {top1}, {shared}/{len(d32)} shared")
    small = np.ascontiguousarray(frame[:120, :160])
    got = TPUMiner(model, max_det=32, dtype=torch.bfloat16, device=DEVICE).detect(
        small, thresh=-1e8)
    want = TPUMiner(model, max_det=32, dtype=torch.bfloat16, device="cpu").detect(
        small, thresh=-1e8)
    cpu_shared = len({root_key(d) for d in got} & {root_key(d) for d in want})
    whole = sum(any(same_placements(np, [g], [w], math.inf, math.inf) for w in want)
                for g in got)
    if cpu_shared < int(0.8 * len(want)):
        raise AssertionError(f"bf16_mine: {cpu_shared}/{len(want)} placements shared "
                             "with the CPU bf16 miner at 120x160")
    ms = statistics.median(t16)
    log("bf16_mine", imsize="x".join(map(str, frame.shape[:2])), max_det=64,
        placements=len(d16), deterministic=True,
        launches=",".join(f"{k}:{v}" for k, v in counts.items()),
        roots_shared_with_f32=f"{shared}/{len(d32)}", f32_top1_root_found=top1,
        cpu_roots_shared_120x160=f"{cpu_shared}/{len(want)}",
        cpu_placements_shared_120x160=f"{whole}/{len(want)}",
        ms_per_mine_median=f"{ms:.3f}", f32_ms_per_mine_median=f"{statistics.median(t32):.3f}",
        ms_all=",".join(f"{t:.3f}" for t in t16), card=f"'{card}'")
    return {"counts": counts, "ms": ms}


def engine_steps(torch, np, pbd_train, model, packed, imsize, batch, device, engine,
                 nsteps, seed=0):
    """nsteps non-latent SGD steps (LatentHingeLoss.value_and_grad, the
    optimizer step, the defs projection) with `engine`'s conv; returns
    (losses, each step's gradients, the pools, seconds per step)."""
    from partsbaseddetector_tpu_torch.train.sgd import LatentHingeLoss, project_defs

    rng = np.random.RandomState(seed)
    imgs = torch.as_tensor((rng.rand(batch, *imsize, 3) * 255.0).astype(np.float32),
                           device=device)
    labels = np.array([1.0, -1.0] * (batch // 2), np.float32)
    loss_fn = LatentHingeLoss(packed, imsize, 1e-4, 1.0, latent=False, engine=engine)
    params = pbd_train.model_params(model, device)
    opt = pbd_train.sgd_momentum(params.values())
    losses, grads, secs = [], [], []
    for _ in range(nsteps):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g = loss_fn.value_and_grad(params, imgs, labels)
        grads.append({k: v.detach().cpu().clone() for k, v in g.items()})
        opt.step()
        project_defs(params)
        if device != "cpu":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return losses, grads, params, secs


def check_fourier_train(torch, np, pbd, pbd_train, dt_cuda, conv_cuda, tc, card) -> dict:
    """Training with the Fourier engine (root_scores(params,
    engine="fourier"): the filters' spectra from the traced filters,
    cuFFT under autograd) on person26, two steps at batch 2, 120x160:
    K1 and K4 launched and K2 not; losses and each step's gradients
    within 5e-3 * max(1, |x|) of the spatial engine's on the card, and
    within rtol 1e-4, atol 1e-4 of the CPU path's Fourier steps (the
    FFT libraries round differently: tests/test_torch_fourier.py's bound
    against jnp.fft); then ms/step of both engines at batch 8, 240x320,
    in turns."""
    from partsbaseddetector_tpu_torch.models import pack_model

    model = pbd.make_person_like_model()
    packed = pack_model(model)
    small = (120, 160)
    zero_counts(dt_cuda, conv_cuda, tc)
    dt_cuda.bwd_launches = 0
    fl, fg, _, _ = engine_steps(torch, np, pbd_train, model, packed, small, 2, DEVICE,
                                "fourier", 2)
    counts = {"dt1d": dt_cuda.launches, "dt1d_bwd": dt_cuda.bwd_launches,
              "conv": conv_cuda.launches, "transpose": tc.launches}
    require_counts("fourier_train", counts, ("dt1d", "dt1d_bwd", "transpose"), ("conv",))
    sl, sg, _, _ = engine_steps(torch, np, pbd_train, model, packed, small, 2, DEVICE,
                                "spatial", 2)
    cl, cg, _, _ = engine_steps(torch, np, pbd_train, model, packed, small, 2, "cpu",
                                "fourier", 2)

    def worst(a, b, rtol, atol):
        return max(float(((x - y).abs() / (atol + rtol * y.abs())).max())
                   for x, y in zip(a, b))

    vs_spatial = max(worst([torch.tensor(fl)], [torch.tensor(sl)], 5e-3, 5e-3),
                     *(worst([g[k] for g in fg], [g[k] for g in sg], 5e-3, 5e-3)
                       for k in fg[0]))
    vs_cpu = max(worst([torch.tensor(fl)], [torch.tensor(cl)], 1e-4, 1e-4),
                 *(worst([g[k] for g in fg], [g[k] for g in cg], 1e-4, 1e-4)
                   for k in fg[0]))
    if not all(math.isfinite(x) for x in fl) or vs_spatial > 1 or vs_cpu > 1:
        raise AssertionError(f"fourier_train: error over bound {vs_spatial:.3g} against "
                             f"spatial, {vs_cpu:.3g} against the CPU")
    (big, nbig), fsecs, ssecs = TRAIN_BATCH, [], []
    for _ in range(2):
        ssecs += engine_steps(torch, np, pbd_train, model, packed, big, nbig, DEVICE,
                              "spatial", 1)[3]
        fsecs += engine_steps(torch, np, pbd_train, model, packed, big, nbig, DEVICE,
                              "fourier", 1)[3]
    ms = statistics.median(fsecs) * 1e3
    log("fourier_train", model="person26", imsize="120x160", batch=2, steps=2,
        launches=",".join(f"{k}:{v}" for k, v in counts.items()),
        losses=",".join(f"{x:.6f}" for x in fl),
        spatial_losses=",".join(f"{x:.6f}" for x in sl),
        cpu_losses=",".join(f"{x:.6f}" for x in cl),
        err_over_bound_vs_spatial=f"{vs_spatial:.3g}", err_over_bound_vs_cpu=f"{vs_cpu:.3g}",
        timed="x".join(map(str, big)) + f" batch {nbig}",
        ms_per_step=",".join(f"{t * 1e3:.3f}" for t in fsecs),
        spatial_ms_per_step=",".join(f"{t * 1e3:.3f}" for t in ssecs),
        card=f"'{card}'")
    return {"counts": counts, "ms": ms}


def check_examples(torch, np, dt_cuda, conv_cuda, tc, card) -> dict:
    """The port's two examples on the card at their small sizes, their
    output kept off this script's: the RGB-D serving demo (3 synchronized
    180x240 frames, K1, K2 and T2 launched, candidates and poses found)
    and the training demo with --fast (its miner on the card: K1 and K2
    launched; held-out PCK@0.5 at least 0.5 for every part)."""
    import io

    from partsbaseddetector_tpu_torch.examples import rgbd_serving_demo, training_demo

    zero_counts(dt_cuda, conv_cuda, tc)
    with contextlib.redirect_stdout(io.StringIO()) as rgbd_out:
        frames, rgbd_s = timed_run(torch, lambda: rgbd_serving_demo.main(["--device", DEVICE]))
    rgbd = mine_counts(dt_cuda, conv_cuda, tc)
    require_counts("examples_rgbd", rgbd, ("dt1d", "conv", "transpose"))
    ncand = [len(f.candidates) for f in frames]
    if len(frames) != 3 or not sum(ncand):
        raise AssertionError(f"examples: the RGB-D demo gave {ncand} candidates")
    zero_counts(dt_cuda, conv_cuda, tc)
    with contextlib.redirect_stdout(io.StringIO()) as train_out:
        (model, pck), train_s = timed_run(
            torch, lambda: training_demo.main(["--fast", "--device", DEVICE]))
    train = mine_counts(dt_cuda, conv_cuda, tc)
    require_counts("examples_training", train, ("dt1d", "conv"))
    model.validate()
    if float(np.min(pck)) < 0.5:
        raise AssertionError(f"examples: the training demo's PCK is {pck}")
    log("examples", rgbd_serving_demo=f"{rgbd_s:.3f}s", rgbd_candidates=ncand,
        rgbd_launches=",".join(f"{k}:{v}" for k, v in rgbd.items()),
        rgbd_lines=len(rgbd_out.getvalue().splitlines()),
        training_demo=f"{train_s:.3f}s", training_pck=",".join(f"{x:.3f}" for x in pck),
        training_launches=",".join(f"{k}:{v}" for k, v in train.items()),
        training_lines=len(train_out.getvalue().splitlines()), card=f"'{card}'")
    return {"rgbd": rgbd, "training": train}


def face68_model(pbd):
    """The frontal-face part count (68 landmarks) at the face model's
    shape: 3 mixtures, 5x5 filters, sbin 4, interval 5; F = 204 filters,
    two N blocks of K2."""
    return pbd.make_synthetic_model(name="face68", nparts=68, nmix=3, fsize=(5, 5),
                                    sbin=4, interval=5, thresh=0.25, seed=0)


def check_face(torch, np, pbd, conv, conv_cuda, pipeline, dt_cuda, tc, im, card) -> dict:
    """Config 1's face model (39 parts x 3 mixtures: F = 117, a partial
    last n8 tile in K2) and the 68-part model (F = 204: two N blocks) at
    480x640, one bucket per octave (interval 5), thresh -1e9: K1, K3, K2
    and T2 launched by one detect (the counts set to 0 just before it),
    finite and two runs identical, the ms/image median of 7, a profile,
    K2's launch on the detect's buckets against the plain version
    (check_conv_detect), and the CPU path's candidates at 120x160 (32
    detections) at the person26 phase's gate. Returns each model's
    launches and K2 row."""
    out = {}
    for model in (pbd.make_face_like_model(), face68_model(pbd)):
        model.thresh = -1e9
        name, nparts = model.name, len(model.parentid[0])
        det = pbd.PartsBasedDetector(model, buckets_per_octave=1, device=DEVICE)
        zero_counts(dt_cuda, conv_cuda, tc)
        first = det.detect(im)
        torch.cuda.synchronize()
        counts = mine_counts(dt_cuda, conv_cuda, tc)
        require_counts(name, counts, ("dt1d", "dt1d_aux", "conv", "transpose"))
        if not first or not all(np.isfinite(c.score) and np.isfinite(c.parts).all()
                                and c.parts.shape == (nparts, 4) for c in first):
            raise AssertionError(f"{name}: no candidates, or malformed ones")
        if not same_candidates(first, det.detect(im)):
            raise AssertionError(f"{name}: two runs differ")
        times = [timed_detect(torch, det, im) for _ in range(7)]
        ms = statistics.median(times)
        families = profile_person26(torch, det, im, ms, phase=f"{name}_profile")
        k2 = check_conv_detect(torch, conv, conv_cuda, pipeline, det, im, card,
                               phase=f"{name}_conv", dms=families["conv"])
        small = im[:120, :160]
        kw = dict(buckets_per_octave=1, max_detections=32)
        want = pbd.PartsBasedDetector(model, device="cpu", **kw).detect(small)
        got = pbd.PartsBasedDetector(model, device=DEVICE, **kw).detect(small)
        if not want or not same_candidates(got, want, score_tol=1e-4, box_tol=1e-3):
            raise AssertionError(f"{name}: CUDA and CPU paths differ at 120x160: "
                                 + difference(got, want))
        log(name, imsize="480x640", parts=nparts, filters=k2["filters"],
            buckets_per_octave=1, candidates=len(first),
            top_score=f"{first[0].score:.4f}", deterministic=True,
            **{f"{k}_launches": v for k, v in counts.items()},
            ms_per_image_median=f"{ms:.3f}", ms_all=",".join(f"{t:.3f}" for t in times),
            k2_ms=f"{k2['ms']:.4f}", k2_device_ms=f"{k2['device_ms']:.4f}",
            k2_bound_ms=f"{k2['bound_ms']:.4f}",
            cpu_match_120x160=f"{len(want)} candidates", card=f"'{card}'")
        out[name] = {"counts": counts, "ms": ms, "k2": k2}
    return out


def check_bench(torch, card) -> None:
    """The port's bench entry point in a subprocess, as a user runs it
    (python -m partsbaseddetector_tpu_torch.bench --samples 1): exit 0, a
    compact record for each of configs 1-6 and the hybrid profile with
    none skipped or erred, every record printed again at the end in the
    same order, the headline last."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "partsbaseddetector_tpu_torch.bench", "--samples", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    if proc.returncode != 0:
        raise AssertionError(f"bench: exit {proc.returncode}: "
                             + "; ".join(proc.stdout.splitlines()[-4:])
                             + proc.stderr[-1500:])
    records = [r for r in lines if "config" in r and not r.get("detail")
               and not r.get("headline")]
    keys = [(r["config"], r.get("profile")) for r in records]
    want = [(2, None), (6, None), (2, "hybrid"), (1, None), (4, None), (5, None),
            (3, None)]
    if keys != want + want:
        raise AssertionError(f"bench: records {keys}, want {want} twice")
    bad = [r for r in records if "value" not in r or r.get("gate") is False]
    if bad:
        raise AssertionError(f"bench: skipped, erred or failed a gate: {bad}")
    if records[: len(want)] != records[len(want):] or lines[-len(want) - 1:-1] != records[len(want):]:
        raise AssertionError("bench: the records at the end differ from the first ones")
    head = lines[-1]
    if not head.get("headline") or head["value"] != records[0]["value"]:
        raise AssertionError(f"bench: the last line is not the headline: {head}")
    for r in records[: len(want)]:
        log("bench_record", **{k: (f"'{v}'" if isinstance(v, str) else v)
                               for k, v in r.items()})
    log("bench", seconds=f"{secs:.1f}", exit_code=proc.returncode, records=len(want),
        headline_images_per_s=head["value"], card=f"'{card}'")


LONE_WINDOWS = 20


def check_lone_launches(torch, dt_cuda, conv_cuda, tc, cp, harness, variants, det, im,
                        card) -> dict:
    """LONE_WINDOWS profiler windows of one bare launch each (a wrapper's
    launch on flat arguments, without its tensor code) of K1, K3's x
    pass, K2, K4, K5, T2 and T1 at the kernel table's shapes: every
    window must record its one kernel event (utils/profiling.py::
    profiled). Beside the profiler's reading, CUDA events recorded tight
    around LONE_WINDOWS bare launches of each. Returns each kernel's
    median device ms and median event ms."""
    dev = DEVICE
    gen = torch.Generator().manual_seed(15)

    def maps(bsz, h, w, aux=False):
        src = 3 * torch.randn((bsz, h, w), generator=gen)
        a = -(0.01 + 0.05 * torch.rand((bsz,), generator=gen))
        b = 0.3 * torch.randn((bsz,), generator=gen)
        shift = torch.randint(-3, 4, (bsz,), generator=gen).float()
        nvalid = torch.full((bsz,), h, dtype=torch.int32)
        ax = torch.randint(0, 4096, (bsz, h, w), generator=gen, dtype=torch.int32)
        return [t.to(dev) for t in (src, a, b, shift, nvalid)] + [
            ax.to(dev) if aux else None]

    y, x, yb = maps(80, 126, 166), maps(80, 166, 126, aux=True), maps(320, 66, 86)
    out, ptr = dt_cuda._dt1d_cuda(*yb[:5], 66, 1, None)
    g = torch.randn(tuple(out.shape), generator=gen).to(dev)
    feat = torch.rand((5, 130, 170, 32), generator=gen).to(dev)
    filt = (0.1 * torch.randn((104, 5, 5, 32), generator=gen)).to(dev)
    bank = conv_cuda.split_bank(filt)
    win_y, _ = variants.window_passes(torch, det, im)
    t = torch.randn((80, 126, 166), generator=gen).to(dev)
    feat_np, filt_np = harness.seeded_inputs(5, 126, 166, 104)
    feat_t = torch.as_tensor(feat_np, device=dev).permute(0, 1, 3, 2).contiguous()
    w2 = cp.weights_k_major(torch.as_tensor(filt_np, device=dev))
    runs = {
        "K1": (lambda: dt_cuda._dt1d_cuda(*y[:5], 126, 1, None), "dt1d"),
        "K3": (lambda: dt_cuda._dt1d_cuda(*x[:5], 166, 1, x[5]), "dt1d_aux"),
        "K2": (lambda: conv_cuda._grouped_cuda([feat], filt, bank), "conv"),
        "K4": (lambda: dt_cuda._dt1d_bwd_cuda(g, out, ptr, yb[3], 66, 1, False),
               "dt1d_bwd"),
        "K5": (lambda: dt_cuda._dt1d_window_cuda(*win_y), "dt1d_window"),
        "T2": (lambda: tc._transpose_cuda(t), "transpose"),
        "T1": (lambda: cp._conv_proto_cuda(feat_t, w2, 104, 2, 5, 5), "conv"),
    }
    dms, ems = {}, {}
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for name, (run, fam) in runs.items():
        run()
        events, times, event_times = 0, [], []
        for _ in range(LONE_WINDOWS):
            got = profiled(run)
            if got["launches"][fam] != 1:
                raise AssertionError(f"lone_launches {name}: {got['launches']}")
            events += got["launches"][fam]
            times.append(got["families"]["dt1d" if fam == "dt1d_aux" else fam])
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            event_times.append(start.elapsed_time(end))
        dms[name], ems[name] = statistics.median(times), statistics.median(event_times)
        log("lone_launch", kernel=name, family=fam, windows=LONE_WINDOWS,
            events=events, device_ms=f"{dms[name]:.4f}",
            device_ms_min_max=f"{min(times):.4f},{max(times):.4f}",
            event_ms=f"{ems[name]:.4f}")
    log("lone_launches", windows_per_kernel=LONE_WINDOWS, complete=True,
        **{f"{k}_device_ms": f"{v:.4f}" for k, v in dms.items()},
        **{f"{k}_event_ms": f"{v:.4f}" for k, v in ems.items()}, card=f"'{card}'")
    return {"device_ms": dms, "event_ms": ems}


def lone_launches_process(card) -> dict:
    """Phase 28 in a new process, `python3 chip_smoke.py --lone-launches`,
    started after the bench: in this process, after every earlier phase,
    torch.profiler dropped the record of the first lone window (PERF.md
    §6), which check_lone_launches refuses. Its lines go to this stdout;
    returns its result."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--lone-launches"],
                          capture_output=True, text=True, cwd=ROOT, timeout=600)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0:
        print("\n".join(lines), flush=True)
        raise AssertionError(f"lone_launches: exit {proc.returncode}: {proc.stderr[-3000:]}")
    print("\n".join(lines[:-1]), flush=True)
    log("lone_launches_process", seconds=f"{time.perf_counter() - t0:.1f}", card=f"'{card}'")
    return json.loads(lines[-1])


def check_dt_public(torch, dtm, card) -> None:
    """ops.shift_distance_transform_2d and ops.distance_transform_2d on
    the card (K1, K3's x pass and T2) against the same calls on the CPU
    (their plain versions) at person26 VGA's finest bucket, 4 parts x 5
    scales x 4 mixtures of 126x166 maps with per-part, per-mixture
    weights and shifts (steps 1 and 2, and the anchored same-size grid):
    values and pointers bit for bit, and (Ix, Iy) the fields of the
    packed pointers."""
    gen = torch.Generator().manual_seed(16)
    score = 3 * torch.randn((4, 5, 4, 126, 166), generator=gen)
    wdef = 0.01 + 0.05 * torch.rand((4, 1, 4, 4), generator=gen)
    wdef[..., 1::2] = 0.02 * torch.randn((4, 1, 4, 2), generator=gen)
    sx = torch.randint(-3, 4, (4, 1, 4), generator=gen)
    sy = torch.randint(-3, 4, (4, 1, 4), generator=gen)
    # (name, shift_x, shift_y, dlen_x, dlen_y, step); "anchored" is
    # distance_transform_2d's grid
    cases = [("shift_step1", sx, sy, 160, 120, 1), ("shift_step2", sx, sy, 83, 63, 2),
             ("anchored", sy, sx, 166, 126, 1)]
    for name, shx, shy, dlx, dly, step in cases:
        def call(dev):
            args = (score.to(dev), wdef.to(dev), shx, shy)
            if name == "anchored":
                return dtm.distance_transform_2d(*args)
            return dtm.shift_distance_transform_2d(*args, dlx, dly, step)

        before = launch_counts()
        got = call(DEVICE)
        torch.cuda.synchronize()
        counted = launches_since(before)
        if counted["dt1d"] != 2 or counted["dt1d_aux"] != 1 or counted["transpose"] != 2:
            raise AssertionError(f"dt_public {name}: launches {counted}")
        want = call("cpu")
        for what, gv, wv in zip(("values", "Ix", "Iy"), got, want):
            if gv.shape != wv.shape or not torch.equal(gv.cpu(), wv):
                raise AssertionError(f"dt_public {name}: {what} differ from the CPU path")
        _, packed = dtm.shift_distance_transform_2d_packed(
            score.to(DEVICE), wdef.to(DEVICE), shx, shy, dlx, dly, step)
        if not (torch.equal(got[1], packed & 0xFFF) and torch.equal(got[2], packed >> 12)):
            raise AssertionError(f"dt_public {name}: (Ix, Iy) are not the packed fields")
    log("dt_public", shape="(4,5,4,126,166)", cases=",".join(c[0] for c in cases),
        equal_to_cpu="values and pointers bit for bit",
        launches_per_call="K1 2 (K3 1), T2 2", card=f"'{card}'")


def main() -> int:
    global cuda_ms, device_ms, device_profile, profiled, launch_counts, launches_since
    global require_launches, window
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
        from partsbaseddetector_tpu_torch import kernels, pipeline
        from partsbaseddetector_tpu_torch.ops import conv, conv_cuda, dt_cuda, nms
        from partsbaseddetector_tpu_torch.ops import conv_proto_cuda as cp
        from partsbaseddetector_tpu_torch.tools import conv_proto as harness
        from partsbaseddetector_tpu_torch.tools import kernel_variants as variants
        from partsbaseddetector_tpu_torch.ops import distance_transform as dtm
        from partsbaseddetector_tpu_torch.ops import transpose_cuda as tc
        from partsbaseddetector_tpu_torch.utils.profiling import (
            cuda_ms, device_ms, device_profile, launch_counts, launches_since, profiled,
            require_launches, window)
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    if sys.argv[1:] == ["--lone-launches"]:
        kernels.library()
        print(json.dumps(check_lone_launches(torch, dt_cuda, conv_cuda, tc, cp, harness,
                                             variants, None, None, card)))
        return 0
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
    conv_table = check_conv(torch, conv, conv_cuda, gen)
    check_golden(np, pbd)
    counts, ms, det, im = check_person26(
        torch, np, pbd, dt_cuda, conv_cuda, tc, gen, card
    )
    # the phases whose profiler windows hold a few launches each
    conv_row = check_conv_detect(torch, conv, conv_cuda, pipeline, det, im, card)
    count_dt_glue(torch, dt_cuda, dtm, det, im)
    tp_row = check_transpose(torch, np, tc, dtm, gen, det, im)
    bwd_row = check_dt_bwd(torch, dt_cuda, kernels, gen)
    win_row = check_dt_window(torch, dt_cuda, variants, gen, det, im)
    t1_row = check_conv_proto(torch, cp, conv_cuda, harness)
    check_nms(torch, np, pbd, nms, im, card)
    profile_person26(torch, det, im, ms)
    train = check_train(torch, np, pbd, pbd_train, dt_cuda, card)
    mine = check_mine(torch, np, pbd, dt_cuda, conv_cuda, tc, gen, card)
    win = check_window_detect(torch, dt_cuda, conv_cuda, det, im, card)
    with window_dt(True):
        profile_person26(torch, det, im, win["ms"], phase="window_profile")
    det_f, ms_f = check_fourier(torch, np, pbd, dt_cuda, conv_cuda, im, card)
    profile_person26(torch, det_f, im, ms_f, phase="fourier_profile")
    check_rgbd(torch, np, pbd, dt_cuda, conv_cuda, im, card)
    serving = check_serving(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card)
    check_stream(torch, np, pbd, im, card)
    have_yaml = importlib.util.find_spec("yaml") is not None
    have_pil = importlib.util.find_spec("PIL") is not None
    surf = check_surfaces(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card,
                          have_yaml, have_pil)
    hybrid = check_hybrid(torch, np, pbd, dt_cuda, conv_cuda, tc, det, im, card)
    check_hybrid_serving(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card)
    hyb = hybrid["counts"]
    par = check_parallel(torch, np, pbd, pbd_train, dt_cuda, conv_cuda, tc, im, card)
    plain16 = check_bf16_plain(torch, np, pbd, dt_cuda, conv_cuda, tc, det, im, card)["counts"]
    mine16 = check_bf16_mine(torch, np, pbd, dt_cuda, conv_cuda, tc, im, card)["counts"]
    ftrain = check_fourier_train(torch, np, pbd, pbd_train, dt_cuda, conv_cuda, tc,
                                 card)["counts"]
    ex = check_examples(torch, np, dt_cuda, conv_cuda, tc, card)
    face = check_face(torch, np, pbd, conv, conv_cuda, pipeline, dt_cuda, tc, im, card)
    check_bench(torch, card)
    check_dt_public(torch, dtm, card)
    lone = lone_launches_process(card)
    ps, pf, pt = par["spatial"]["counts"], par["fourier"]["counts"], par["train"]["counts"]
    exr, ext = ex["rgbd"], ex["training"]
    face_launches = lambda k: {m: face[m]["counts"][k] for m in face}

    table = {"kernels": [
        {"name": "dt1d_axis2", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d.cu",
         "core": "partsbaseddetector_tpu_torch/csrc/dt1d_core.cuh",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:518",
         "also_replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:75",
         "launches": counts["dt1d"], "hybrid_launches": hyb["dt1d"],
         "mine_launches": mine["dt1d"], "surfaces_launches": surf["dt1d"],
         "parallel_launches": {"spatial": ps["dt1d"], "fourier": pf["dt1d"],
                               "train": pt["dt1d"]},
         "bf16_plain_launches": plain16["dt1d"], "bf16_mine_launches": mine16["dt1d"],
         "fourier_train_launches": ftrain["dt1d"],
         "examples_launches": {"rgbd": exr["dt1d"], "training": ext["dt1d"]},
         "face_launches": face_launches("dt1d"), **dt_row,
         "lone_launch_device_ms": lone["device_ms"]["K1"],
         "lone_launch_event_ms": lone["event_ms"]["K1"]},
        # K3's row: the same kernel's x passes (the transposed map, aux),
        # counted where they launch
        {"name": "dt1d_axis2_xpass", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d.cu",
         "core": "partsbaseddetector_tpu_torch/csrc/dt1d_core.cuh",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:75",
         "launches": counts["dt1d_aux"], "hybrid_launches": hyb["dt1d_aux"],
         "mine_launches": mine["dt1d_aux"], "surfaces_launches": surf["dt1d_aux"],
         "parallel_launches": {"spatial": ps["dt1d_aux"], "fourier": pf["dt1d_aux"]},
         "bf16_plain_launches": plain16["dt1d_aux"],
         "bf16_mine_launches": mine16["dt1d_aux"],
         "examples_launches": {"rgbd": exr["dt1d_aux"], "training": ext["dt1d_aux"]},
         "face_launches": face_launches("dt1d_aux"), **xpass_row,
         "lone_launch_device_ms": lone["device_ms"]["K3"],
         "lone_launch_event_ms": lone["event_ms"]["K3"]},
        {"name": "conv3xtf32", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/conv.cu",
         "core": "partsbaseddetector_tpu_torch/csrc/conv_core.cuh",
         "replaces": "partsbaseddetector_tpu/ops/conv_pallas.py:101",
         "launches": counts["conv"], "hybrid_launches": hyb["conv"],
         "mine_launches": mine["conv"], "surfaces_launches": surf["conv"],
         "parallel_launches": {"spatial": ps["conv"], "fourier": pf["conv"],
                               "train": pt["conv"]},
         "bf16_plain_launches": plain16["conv"], "bf16_mine_launches": mine16["conv"],
         "fourier_train_launches": ftrain["conv"],
         "examples_launches": {"rgbd": exr["conv"], "training": ext["conv"]}, **conv_row,
         "face_launches": face_launches("conv"),
         "face_detects": {m: face[m]["k2"] for m in face},
         "table_shape": conv_table, "lone_launch_device_ms": lone["device_ms"]["K2"],
         "lone_launch_event_ms": lone["event_ms"]["K2"]},
        {"name": "dt1d_axis2_bwd", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d_bwd.cu",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:809",
         "launches": train["launches"], "parallel_launches": {"train": pt["dt1d_bwd"]},
         "fourier_train_launches": ftrain["dt1d_bwd"], **bwd_row,
         "lone_launch_device_ms": lone["device_ms"]["K4"],
         "lone_launch_event_ms": lone["event_ms"]["K4"]},
        {"name": "dt1d_window_axis2", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/dt1d_window.cu",
         "core": "partsbaseddetector_tpu_torch/csrc/dt1d_core.cuh",
         "replaces": "partsbaseddetector_tpu/ops/pallas_dt.py:321",
         "launches": win["launches"], **win_row, "lone_launch_device_ms": lone["device_ms"]["K5"],
         "lone_launch_event_ms": lone["event_ms"]["K5"]},
        {"name": "transpose32", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/transpose.cu",
         "replaces": "tools/transpose_kernel_probe.py:25",
         "launches": serving["counts"]["transpose"],
         "hybrid_launches": hyb["transpose"], "mine_launches": mine["transpose"],
         "surfaces_launches": surf["transpose"],
         "parallel_launches": {"spatial": ps["transpose"], "fourier": pf["transpose"]},
         "bf16_plain_launches": plain16["transpose"],
         "bf16_mine_launches": mine16["transpose"],
         "fourier_train_launches": ftrain["transpose"],
         "examples_launches": {"rgbd": exr["transpose"], "training": ext["transpose"]},
         "face_launches": face_launches("transpose"), **tp_row,
         "lone_launch_device_ms": lone["device_ms"]["T2"],
         "lone_launch_event_ms": lone["event_ms"]["T2"]},
        {"name": "conv_proto_3xtf32", "route": "cuda",
         "source": "partsbaseddetector_tpu_torch/csrc/conv_proto.cu",
         "core": "partsbaseddetector_tpu_torch/csrc/conv_core.cuh",
         "replaces": "tools/conv_pallas_proto.py:62",
         "pallas_call": "tools/conv_pallas_proto.py:88", **t1_row,
         "lone_launch_device_ms": lone["device_ms"]["T1"],
         "lone_launch_event_ms": lone["event_ms"]["T1"]},
    ]}
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
