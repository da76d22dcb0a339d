"""Serializable detection messages (the ros/Messages.cpp surface).

Builds transport-agnostic dict messages from detection results — the
same payloads the reference publishes as ROS topics (ros/Node.cpp:120-130,
Messages.cpp): per-candidate image overlays, labeled masks, 3-D cube
markers with deterministic per-name colors, cluster clouds and PCA
poses. Any transport (ROS bridge, JSON-RPC, protobuf) can wrap these.

A copy of `partsbaseddetector_tpu/apps/messages.py` on the port's
`cloud`, `depth`, `types` and `visualize`.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np

from ..cloud import estimate_poses
from ..depth import Rect3
from ..types import Candidate
from ..visualize import Visualize


def hash_string_to_color(name: str) -> tuple:
    """Deterministic RGBA color from an object name
    (Messages.cpp:55-66)."""
    digest = hashlib.md5(name.encode()).digest()
    return (digest[0] / 255.0, digest[1] / 255.0, digest[2] / 255.0, 0.95)


def message_bounding_boxes(
    boxes3d: Sequence[Rect3],
    object_name: str = "object",
    frame_id: str = "camera",
    lifetime_sec: float = 5.0,
) -> List[Dict]:
    """Cube marker messages (Messages.cpp:76-130 messageBoundingBox)."""
    color = hash_string_to_color(object_name)
    markers = []
    for i, box in enumerate(boxes3d):
        cx, cy, cz = box.centroid()
        markers.append(
            dict(
                type="cube",
                id=i,
                ns=object_name,
                frame_id=frame_id,
                lifetime_sec=lifetime_sec,
                position=(cx, cy, cz),
                scale=(box.width, box.height, box.depth),
                color=color,
            )
        )
    return markers


def message_image_rgb(
    im: np.ndarray, candidates: Sequence[Candidate], name: str = ""
) -> Dict:
    """Annotated-image message (Messages.cpp:136-149)."""
    canvas = Visualize(name).candidates(np.clip(im, 0, 255), candidates)
    return dict(type="image", encoding="rgb8", data=canvas)


def message_mask(
    im_shape, candidates: Sequence[Candidate]
) -> Dict:
    """Labeled instance mask message (Messages.cpp:157-174)."""
    return dict(
        type="image", encoding="mono8", data=Candidate.mask(im_shape, candidates)
    )


def message_clusters(clusters: Sequence[np.ndarray], frame_id="camera") -> Dict:
    """Concatenated cleaned-cloud message (Messages.cpp:176-185)."""
    pts = (
        np.concatenate([c for c in clusters if len(c)], axis=0)
        if any(len(c) for c in clusters)
        else np.zeros((0, 3))
    )
    return dict(type="pointcloud", frame_id=frame_id, points=pts)


def message_poses(
    centroids: Sequence[np.ndarray],
    part_centers: Sequence[np.ndarray],
    frame_id: str = "camera",
) -> Dict:
    """PoseArray message: centroid + PCA orientation
    (Messages.cpp:187-235)."""
    poses = estimate_poses(centroids, part_centers)
    return dict(
        type="pose_array",
        frame_id=frame_id,
        poses=[dict(matrix=p) for p in poses],
    )


def message_frustum(
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    near: float,
    far: float,
    frame_id: str = "camera",
    object_name: str = "frustum",
) -> Dict:
    """Camera view-frustum line-list marker (the intended behavior of
    Messages.cpp:132-134 messageFrustum, an empty stub in the
    reference): the 8 corners of the pinhole frustum between the near
    and far planes plus the 12 edges connecting them, as a
    LINE_LIST-style message any transport can render.

    Corners come from unprojecting the image rectangle through the
    intrinsics at depth z: X = (u - cx) * z / fx, Y = (v - cy) * z / fy.
    """
    corners = []
    for z in (near, far):
        for u, v in ((0, 0), (width, 0), (width, height), (0, height)):
            corners.append(
                ((u - cx) * z / fx, (v - cy) * z / fy, float(z))
            )
    ring = [(0, 1), (1, 2), (2, 3), (3, 0)]
    edges = (
        [(a, b) for a, b in ring]
        + [(a + 4, b + 4) for a, b in ring]
        + [(i, i + 4) for i in range(4)]
    )
    return dict(
        type="marker_line_list",
        frame_id=frame_id,
        color=hash_string_to_color(object_name),
        points=[corners[a] + corners[b] for a, b in edges],
    )
