"""Streaming detection pipeline: the ROS-node-shaped surface.

Mirrors the reference ROS node's frame flow (ros/Node.cpp:144-249):
synchronized RGB + depth (+ optional cloud) in, then per frame
detect -> sort -> paint-NMS(0.1) -> 3-D boxes -> (optional plane
removal) -> clustering -> poses, delivered to subscriber callbacks that
are only invoked when registered (the publish-if-subscribed pattern of
Node.cpp:232-249). No ROS dependency; any transport can sit on top.

A copy of `partsbaseddetector_tpu/apps/stream.py` over the port's
detector: `process_stream` runs `PartsBasedDetector.detect_stream`
(the part-filter responses, the distance transforms and their
transposes on the card), which yields each frame's candidates in the
frames' order at any `workers`; the post stages are host code. Unlike
the JAX package's copy, a uint16 depth frame (millimetres, as the
detector reads it) is converted to metres before the 3-D stages, whose
camera model, boxes and clustering tolerance are in metres; a float
frame is metres already and passes unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from ..cloud import (
    cluster_objects,
    compute_bounding_boxes,
    depth_to_cloud,
    estimate_poses,
    remove_planes,
)
from ..depth import StereoCameraModel
from ..detector import PartsBasedDetector, _depth_meters_host
from ..types import Candidate
from ..visualize import Visualize


@dataclasses.dataclass
class FrameResult:
    candidates: List[Candidate]
    image_rgb: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    boxes3d: Optional[list] = None
    clusters: Optional[list] = None
    poses: Optional[list] = None

    def pose_results(self, object_id: str = "object") -> List[dict]:
        """ecto-cell-shaped results (cells/detect.cpp:213-348
        PoseResult): {object_id, confidence, T, R, cloud} per candidate
        with 3-D post-processing available."""
        out = []
        for i, cand in enumerate(self.candidates):
            pose = (
                self.poses[i]
                if self.poses is not None and i < len(self.poses)
                else np.eye(4)
            )
            out.append(
                dict(
                    object_id=object_id,
                    confidence=cand.score,
                    T=pose[:3, 3],
                    R=pose[:3, :3],
                    cloud=(
                        self.clusters[i]
                        if self.clusters is not None and i < len(self.clusters)
                        else None
                    ),
                )
            )
        return out


class DetectionStream:
    """Callback-driven detection pipeline.

    Register interest via subscribe_* — stages run only when someone
    listens, exactly like the ROS node's subscriber checks.
    """

    def __init__(
        self,
        detector: PartsBasedDetector,
        camera: Optional[StereoCameraModel] = None,
        max_overlap: float = 0.1,
        remove_planes_first: bool = False,
    ):
        self.detector = detector
        self.camera = camera
        self.max_overlap = max_overlap
        self.remove_planes_first = remove_planes_first
        self._subs = {
            k: []
            for k in ("candidates", "image", "mask", "bbox3d", "clusters", "poses")
        }

    def subscribe(self, topic: str, cb: Callable) -> None:
        if topic not in self._subs:
            raise KeyError(f"unknown topic {topic!r}")
        self._subs[topic].append(cb)

    def _wants(self, *topics: str) -> bool:
        return any(self._subs[t] for t in topics)

    def _publish(self, topic: str, payload) -> None:
        for cb in self._subs[topic]:
            cb(payload)

    def process_stream(self, frames, lookahead: int = 2, workers: int = 1):
        """Pipelined frame loop: yields FrameResult per (rgb, depth[,
        cloud]) tuple with up to `lookahead` device programs in flight
        (detector.detect_stream), so device work overlaps the host
        post-stages below. The reference node processes frames strictly
        sequentially (ros/Node.cpp:144); on an accelerator that
        serialization idles the chip between frames."""
        norm = []
        for f in frames:
            if not isinstance(f, tuple):
                f = (f, None, None)
            elif len(f) == 2:
                f = f + (None,)
            norm.append(f)
        det_frames = [(rgb, depth) for rgb, depth, _ in norm]
        for (rgb, depth, cloud), candidates in zip(
            norm,
            self.detector.detect_stream(
                det_frames, lookahead=lookahead, workers=workers
            ),
        ):
            yield self._post(rgb, depth, cloud, candidates)

    def process(
        self,
        rgb: np.ndarray,
        depth: Optional[np.ndarray] = None,
        cloud: Optional[np.ndarray] = None,
    ) -> FrameResult:
        """One synchronized frame through the full node pipeline."""
        candidates = self.detector.detect(rgb, depth)
        return self._post(rgb, depth, cloud, candidates)

    def _post(
        self,
        rgb: np.ndarray,
        depth: Optional[np.ndarray],
        cloud: Optional[np.ndarray],
        candidates: List[Candidate],
    ) -> FrameResult:
        candidates = Candidate.sort(candidates)
        candidates = Candidate.non_maxima_suppression(
            rgb.shape[:2], candidates, self.max_overlap
        )
        result = FrameResult(candidates=candidates)
        self._publish("candidates", candidates)

        if self._wants("image"):
            result.image_rgb = Visualize(self.detector.name).candidates(
                np.clip(rgb, 0, 255), candidates
            )
            self._publish("image", result.image_rgb)
        if self._wants("mask"):
            result.mask = Candidate.mask(rgb.shape[:2], candidates)
            self._publish("mask", result.mask)

        needs_3d = self._wants("bbox3d", "clusters", "poses")
        if needs_3d and depth is not None and self.camera is not None:
            depth = _depth_meters_host(depth)
            boxes3d, centers = compute_bounding_boxes(
                candidates, rgb.shape[:2], depth, self.camera
            )
            result.boxes3d = boxes3d
            self._publish("bbox3d", boxes3d)
            if self._wants("clusters", "poses"):
                pc = cloud if cloud is not None else depth_to_cloud(depth, self.camera)
                if self.remove_planes_first:
                    pc = remove_planes(pc)
                clusters, centroids = cluster_objects(pc, boxes3d)
                result.clusters = clusters
                self._publish("clusters", clusters)
                if self._wants("poses"):
                    result.poses = estimate_poses(centroids, centers)
                    self._publish("poses", result.poses)
        return result
