"""Does the card's pyramid depend on the batch? A probe on the card.

Runs person26's pyramid (buckets_per_octave=2) on the seed-0 VGA frames
(the first draw of a seed-0 generator, frames clip(im + i), i = 0..7).
For frame 1 it compares B = 1 against B = 8 stage by stage: each scale's
resized image, the HOG features of the batch's images taken alone, and
for every frame the features of every bucket. It compares frame 1's
resized images and HOG choices on the card with the CPU's, reads the
colour and orientation choices at the known near-ties (ROADMAP.md §3),
and measures the pyramid's device ops and busy ms per image at B = 1 and
8 (torch.profiler).

With --baseline-dir the same measurement runs, in a process of its own,
on an earlier checkout's port: the directory that holds its
`partsbaseddetector_tpu_torch` package, for example

    git archive b3e2d19 | tar -x -C build/baseline_port

Its images at the near-ties are read with this checkout's `hog_choices`.

    python -m partsbaseddetector_tpu_torch.tools.pyramid_probe [--baseline-dir DIR]

The last line is one JSON object with the results and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# (scale, gradient-grid pixel) of the near-ties to read
NEAR_TIES = ((11, (71, 252)), (31, (6, 22)))


def measure(device: str, save=None) -> dict:
    """The probe on whichever `partsbaseddetector_tpu_torch` package the
    import finds (absolute imports, so that a baseline's process measures
    its own). save (optional): a path for frame 1's images at the
    near-tie scales, alone and in the batch."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from partsbaseddetector_tpu_torch.models.model import make_person_like_model, pack_model
    from partsbaseddetector_tpu_torch.ops import hog, pyramid

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    im = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0)).numpy()
    frames = np.stack([np.clip(im.astype(np.int16) + i, 0, 255).astype(np.uint8)
                       for i in range(8)])
    packed = pack_model(make_person_like_model())
    spec = packed.spec
    plan = pyramid.build_plan((480, 640), spec, *packed.filters.shape[1:3],
                              buckets_per_octave=2)
    batch = torch.as_tensor(frames, device=dev).float()
    differ = lambda a, b: (a - b).abs().max().item()

    b8 = pyramid._scale_images(batch, plan, spec)
    b1 = pyramid._scale_images(batch[1:2], plan, spec)
    images = [(s, differ(x[1], y[0])) for s, (x, y) in enumerate(zip(b8, b1))
              if not torch.equal(x[1], y[0])]
    hog_same = []
    for s, x in enumerate(b8):
        alone = hog.hog_features(x[1:2], spec.sbin)[0]
        inside = hog.hog_features(x, spec.sbin)[1]
        if not torch.equal(alone, inside):
            hog_same.append((s, differ(alone, inside)))
    together = pyramid.build_pyramid_features(batch, plan, spec)
    feats = []
    for i in range(len(frames)):
        alone = pyramid.build_pyramid_features(batch[i : i + 1], plan, spec)
        feats += [(i, b, differ(x[0], y[i])) for b, (x, y) in enumerate(zip(alone, together))
                  if not torch.equal(x[0], y[i])]
    res = {
        "nscales": plan.nscales,
        "images_b8_vs_b1": {"scales": [s for s, _ in images],
                            "max_abs": max((d for _, d in images), default=0.0)},
        "hog_b8_vs_b1_same_images": {"scales": [s for s, _ in hog_same],
                                     "max_abs": max((d for _, d in hog_same), default=0.0)},
        "features_b8_vs_b1": {"frame_bucket_pairs": len(frames) * len(together),
                              "differ": feats},
    }
    if save:
        torch.save({s: (b1[s][0].cpu(), b8[s][1].cpu()) for s, _ in NEAR_TIES}, save)
    if dev.type == "cuda":
        cost = {}
        for _ in range(2):  # two rounds, in turns
            for bsz in (1, 8):
                x = batch[:bsz]
                run = lambda: pyramid.build_pyramid_features(x, plan, spec)
                run()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        run()
                    torch.cuda.synchronize()
                ev = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
                us = sum(getattr(e, "self_device_time_total", 0) for e in ev)
                cost.setdefault(f"b{bsz}", []).append(
                    {"device_ops": sum(e.count for e in ev) / (3 * bsz),
                     "busy_ms": us / 1e3 / (3 * bsz)})
        res["cost_per_image"] = cost
    return res


def choices(images: dict) -> dict:
    """This checkout's HOG colour and orientation choices (and v3) at the
    near-tie pixels of frame 1's images, alone and in the batch."""
    from ..models.model import make_person_like_model
    from ..ops import hog

    sbin = make_person_like_model().sbin
    out = {}
    for s, (y, x) in NEAR_TIES:
        for tag, img in zip(("b1", "b8"), images[s]):
            ch, orient, gv = hog.hog_choices(img[None], sbin)
            out[f"scale{s}_px{y},{x}_{tag}"] = (
                int(ch[0, y, x]), int(orient[0, y, x]), float(gv[0, y, x]))
    return out


def card_vs_cpu() -> dict:
    """Frame 1's resized images and HOG choices, card against CPU: the
    scales where they differ."""
    import numpy as np
    import torch

    from ..models.model import make_person_like_model, pack_model
    from ..ops import hog, pyramid

    im = torch.randint(0, 256, (480, 640, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0)).numpy()
    frame = np.clip(im.astype(np.int16) + 1, 0, 255).astype(np.float32)[None]
    packed = pack_model(make_person_like_model())
    spec = packed.spec
    plan = pyramid.build_plan((480, 640), spec, *packed.filters.shape[1:3],
                              buckets_per_octave=2)
    card = pyramid._scale_images(torch.as_tensor(frame, device="cuda"), plan, spec)
    cpu = pyramid._scale_images(torch.as_tensor(frame), plan, spec)
    pick = lambda x: hog.hog_choices(x, spec.sbin)[:2]
    return {
        "images_differ": [s for s in range(plan.nscales)
                          if not torch.equal(card[s].cpu(), cpu[s])],
        "choices_differ": [s for s in range(plan.nscales)
                           if not all(torch.equal(a.cpu(), b)
                                      for a, b in zip(pick(card[s]), pick(cpu[s])))],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-dir", default=None,
                    help="a directory holding an earlier partsbaseddetector_tpu_torch")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if args.worker:  # a baseline's process: its measurement as JSON
        res = measure("cuda", save=args.worker + ".pt")
        with open(args.worker, "w") as fh:
            json.dump(res, fh)
        return 0
    if not torch.cuda.is_available():
        print("pyramid_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        res = {"port": measure("cuda", save=os.path.join(tmp, "port.pt"))}
        res["port"]["near_ties"] = choices(torch.load(os.path.join(tmp, "port.pt")))
        res["port"]["card_vs_cpu_frame1"] = card_vs_cpu()
        if args.baseline_dir:
            base = os.path.abspath(args.baseline_dir)
            out = os.path.join(tmp, "baseline.json")
            # run as a script from the baseline directory, so that the
            # package it imports is the baseline's
            subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", out],
                           cwd=base, env={**os.environ, "PYTHONPATH": base}, check=True)
            with open(out) as fh:
                res["baseline"] = json.load(fh)
            res["baseline"]["near_ties"] = choices(torch.load(out + ".pt"))
    for key, val in res.items():
        for k, v in val.items():
            print(f"[pyramid_probe] {key} {k}: {v}", flush=True)
    print(card)
    print(json.dumps({"card": card, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
