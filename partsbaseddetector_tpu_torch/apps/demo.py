"""Demo CLI (ref: src/demo.cpp).

    python -m partsbaseddetector_tpu_torch.apps.demo MODEL IMAGE [DEPTH]
        [--out annotated.png] [--nms OVERLAP] [--engine spatial|fourier]
        [--device cuda|cpu]

Loads a model by extension (.npz canonical, .xml/.yml FileStorage,
.mat MATLAB), detects, sorts, optionally NMS-filters and depth-filters
(depth images are uint16 millimeters, scaled to meters as demo.cpp:95-99
does), prints candidates and writes an annotated image.

A copy of `partsbaseddetector_tpu/apps/demo.py` over the port's
detector, which runs on --device (default cuda). Reading and writing
images needs PIL, imported only when an image is read or written.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_image(path: str) -> np.ndarray:
    from PIL import Image

    im = Image.open(path)
    return np.asarray(im.convert("RGB"), dtype=np.float32)


def load_depth(path: str) -> np.ndarray:
    from PIL import Image

    d = np.asarray(Image.open(path)).astype(np.float32)
    if d.dtype != np.float32 or d.max() > 100:
        d = d / 1000.0  # uint16 mm -> meters (demo.cpp:97-99)
    return d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pbd-demo", description=__doc__)
    ap.add_argument("model")
    ap.add_argument("image")
    ap.add_argument("depth", nargs="?", default=None)
    ap.add_argument("--out", default="detections.png")
    ap.add_argument("--nms", type=float, default=None, metavar="OVERLAP")
    ap.add_argument("--engine", default="spatial", choices=["spatial", "fourier"])
    ap.add_argument("--max-detections", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="where the detector runs (cuda, cuda:1, cpu)")
    args = ap.parse_args(argv)

    from .. import PartsBasedDetector, load_model
    from ..types import Candidate
    from ..visualize import Visualize

    model = load_model(args.model)
    detector = PartsBasedDetector(
        model, max_detections=args.max_detections, conv_engine=args.engine,
        device=args.device,
    )
    im = load_image(args.image)
    depth = load_depth(args.depth) if args.depth else None

    candidates = detector.detect(im, depth)
    candidates = Candidate.sort(candidates)
    if args.nms is not None:
        candidates = Candidate.non_maxima_suppression(
            im.shape[:2], candidates, args.nms
        )

    print(f"{len(candidates)} candidates (model '{detector.name}')")
    for i, c in enumerate(candidates[:20]):
        bb = c.bounding_box()
        print(
            f"  [{i}] score={c.score:+.4f} comp={c.component} "
            f"bbox=({bb[0]:.0f},{bb[1]:.0f},{bb[2]:.0f},{bb[3]:.0f})"
        )

    vis = Visualize(detector.name)
    canvas = vis.candidates(np.clip(im, 0, 255), candidates, n=20)
    vis.image(canvas, args.out)
    print(f"annotated image -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
