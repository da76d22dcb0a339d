"""Training demo (the reference's training_demo.m, Python edition).

Port of examples/training_demo.py. Trains a small articulated model end
to end on synthetic scenes with a planted three-part pattern, then
evaluates PCK on held-out images, exercising the complete training
stack: point_to_box annotation processing, part-type clustering, warped
per-part SVMs, tree assembly, latent SSVM retraining (mining with the
port's TPUMiner on the chosen device) and the evaluation harness.

Run: python -m partsbaseddetector_tpu_torch.examples.training_demo
[--fast] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from ..cpu_detector import CPUPartsBasedDetector
from ..eval.metrics import boxes_to_keypoints, eval_pck
from ..train.trainmodel import train_model


def make_scene(rng, with_object=True, size=96):
    im = rng.rand(size, size, 3) * 40
    points = None
    if with_object:
        cx = rng.randint(28, size - 44)
        cy = rng.randint(28, size - 44)
        im[cy - 8 : cy + 8, cx - 8 : cx + 8, 0] += 200
        im[cy + 10 : cy + 26, cx - 8 : cx + 8, 1] += 200
        im[cy + 28 : cy + 44, cx - 8 : cx + 8, 2] += 200
        points = np.array([[cx, cy], [cx, cy + 18], [cx, cy + 36]], dtype=float)
    return np.clip(im, 0, 255), points


def main(argv: Optional[List[str]] = None):
    """Runs the demo; returns (model, per-part held-out PCK@0.5)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.RandomState(0)
    pa = [0, 0, 1]  # K mixtures per part, parent indices
    n_train = 8 if args.fast else 16

    positives, negatives = [], []
    for _ in range(n_train):
        im, pts = make_scene(rng)
        positives.append({"im": im, "points": pts})
    for _ in range(4):
        negatives.append({"im": make_scene(rng, False)[0]})

    model = train_model(
        "demo3", positives, negatives, K=[1, 1, 1], pa=pa,
        sbin=8, interval=2, warp_iters=1, latent_iters=1, nmax=400,
        verbose=True, device=args.device,
    )

    # held-out evaluation
    det = CPUPartsBasedDetector(model)
    preds, gts = [], []
    for seed in range(100, 106):
        im, pts = make_scene(np.random.RandomState(seed))
        cands = det.detect(im)
        if cands:
            preds.append(boxes_to_keypoints(cands[0].parts))
            gts.append(pts)
    pck = eval_pck(np.stack(preds), np.stack(gts), thresh=0.5)
    print(f"held-out PCK@0.5 per part: {pck}")
    return model, pck


if __name__ == "__main__":
    main()
