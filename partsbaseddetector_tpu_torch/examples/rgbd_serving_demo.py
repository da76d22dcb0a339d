"""RGB-D serving demo: the full node pipeline on synthetic frames.

Port of examples/rgbd_serving_demo.py. Exercises the ROS-node-shaped
surface end to end without ROS: ApproximateTime-synchronized RGB + depth
frames -> detect -> sort -> paint-NMS -> 3-D boxes -> plane removal ->
clustering -> poses -> serializable messages (BASELINE config 5's RGB-D
variant).

Run: python -m partsbaseddetector_tpu_torch.examples.rgbd_serving_demo
[--device cpu] [--frames N] [--size H W]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from .. import PartsBasedDetector, make_synthetic_model
from ..apps.messages import (
    message_bounding_boxes,
    message_image_rgb,
    message_mask,
    message_poses,
)
from ..apps.stream import DetectionStream
from ..apps.sync import ApproximateTimeSynchronizer
from ..depth import StereoCameraModel


def main(argv: Optional[List[str]] = None) -> list:
    """Runs the demo and returns the FrameResult of every synchronized
    frame."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--size", type=int, nargs=2, default=(180, 240))
    args = ap.parse_args(argv)
    h, w = args.size
    model = make_synthetic_model(
        nparts=4, nmix=2, fsize=(4, 4), sbin=8, interval=3, thresh=2.0, seed=1
    )
    detector = PartsBasedDetector(model, max_detections=64, device=args.device)
    camera = StereoCameraModel(fx=300, fy=300, cx=w / 2, cy=h / 2)
    stream = DetectionStream(detector, camera, max_overlap=0.1)

    frames = []
    stream.subscribe("candidates", lambda c: None)
    stream.subscribe("poses", lambda p: None)

    def on_pair(rgb, depth):
        result = stream.process(rgb, depth)
        frames.append(result)
        print(
            f"frame {len(frames)}: {len(result.candidates)} candidates, "
            f"{len(result.poses or [])} poses"
        )
        if result.candidates:
            markers = message_bounding_boxes(result.boxes3d or [], "demo")
            img_msg = message_image_rgb(rgb, result.candidates)
            mask_msg = message_mask(rgb.shape[:2], result.candidates)
            if result.poses:
                message_poses([p[:3, 3] for p in result.poses], [np.zeros((0, 3))])
            print(
                f"  messages: {len(markers)} markers, image "
                f"{img_msg['data'].shape}, mask labels "
                f"{int(mask_msg['data'].max())}"
            )

    sync = ApproximateTimeSynchronizer(["rgb", "depth"], on_pair, slop=0.05)
    rng = np.random.RandomState(0)
    t = 0.0
    for _ in range(args.frames):
        rgb = (rng.rand(h, w, 3) * 255).astype(np.float32)
        depth = np.full((h, w), 2.0, dtype=np.float32)
        depth += rng.randn(h, w).astype(np.float32) * 0.01
        # slightly skewed timestamps, as real sensors deliver
        sync.push("rgb", t + 0.01 * rng.rand(), rgb)
        sync.push("depth", t + 0.01 * rng.rand(), depth)
        t += 0.1

    print(f"processed {len(frames)} synchronized frames")
    return frames


if __name__ == "__main__":
    main()
