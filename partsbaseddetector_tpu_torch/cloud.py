"""Point-cloud post-processing: 3-D boxes, clustering, pose estimation,
plane removal.

NumPy/SciPy replacement for the reference's PCL pipeline
(include/PointCloudClusterer.hpp + ros/Messages.cpp pose math):
  - compute_bounding_boxes: per-candidate 3-D box + part centers
    projected through the camera at the mean part depth
    (PointCloudClusterer.hpp:52-154);
  - cluster_objects: crop-box around each (expanded) 3-D box ->
    Euclidean clustering (kd-tree, 1 cm tolerance) -> keep the largest
    cluster -> centroid (PointCloudClusterer.hpp:156-292);
  - remove_planes: dominant-plane removal, the organized multi-plane
    segmentation analog (PointCloudClusterer.hpp:294-335) via RANSAC;
  - estimate_poses: centroid + PCA orientation from part centers
    (ros/Messages.cpp:187-235 messagePoses).

Clouds are (N, 3) float arrays; NaN rows are ignored.

A copy of `partsbaseddetector_tpu/cloud.py` on the port's `depth.py`,
so that the port never imports the JAX package. All of it is host code,
as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .depth import Rect3, StereoCameraModel, bounding_box_3d
from .types import Candidate


def _finite(cloud: np.ndarray) -> np.ndarray:
    return cloud[np.isfinite(cloud).all(axis=1)]


def compute_bounding_boxes(
    candidates: Sequence[Candidate],
    im_shape: Tuple[int, int],
    depth: np.ndarray,
    camera: StereoCameraModel,
) -> Tuple[List[Rect3], List[np.ndarray]]:
    """3-D boxes and 3-D part centers per candidate."""
    boxes3d: List[Rect3] = []
    centers: List[np.ndarray] = []
    for cand in candidates:
        box = bounding_box_3d(im_shape, depth, cand)
        boxes3d.append(box)
        pts = []
        for p in range(len(cand.parts)):
            x1, y1, x2, y2 = cand.parts[p]
            u, v = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
            h, w = depth.shape[:2]
            iu = int(np.clip(u * w / im_shape[1], 0, w - 1))
            iv = int(np.clip(v * h / im_shape[0], 0, h - 1))
            z = depth[iv, iu]
            if not np.isfinite(z) or z <= 0:
                z = box.z + box.depth / 2 if np.isfinite(box.z) else np.nan
            pts.append(camera.project_pixel_at_depth(u, v, z))
        centers.append(np.asarray(pts))
    return boxes3d, centers


def euclidean_clusters(
    cloud: np.ndarray,
    tolerance: float = 0.010,
    min_size: int = 1,
) -> List[np.ndarray]:
    """Single-linkage Euclidean clustering with a kd-tree (the
    EuclideanClusterExtraction analog). Returns index arrays, largest
    first."""
    from scipy.spatial import cKDTree

    pts = cloud
    n = len(pts)
    if n == 0:
        return []
    tree = cKDTree(pts)
    labels = np.full(n, -1, dtype=np.int64)
    current = 0
    for seed in range(n):
        if labels[seed] >= 0:
            continue
        stack = [seed]
        labels[seed] = current
        while stack:
            i = stack.pop()
            for j in tree.query_ball_point(pts[i], tolerance):
                if labels[j] < 0:
                    labels[j] = current
                    stack.append(j)
        current += 1
    clusters = [np.flatnonzero(labels == c) for c in range(current)]
    clusters = [c for c in clusters if len(c) >= min_size]
    clusters.sort(key=len, reverse=True)
    return clusters


def cluster_objects(
    cloud: np.ndarray,
    boxes3d: Sequence[Rect3],
    expand: float = 1.2,
    tolerance: float = 0.010,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per 3-D box: crop the cloud to the expand-scaled box, cluster,
    keep the largest cluster. Returns (clusters, centroids)."""
    clusters_out: List[np.ndarray] = []
    centroids: List[np.ndarray] = []
    pts_all = _finite(np.asarray(cloud, dtype=np.float64))
    for box in boxes3d:
        if not np.isfinite([box.x, box.y, box.z]).all():
            clusters_out.append(np.zeros((0, 3)))
            centroids.append(np.full(3, np.nan))
            continue
        cx, cy, cz = box.centroid()
        hw = np.array([box.width, box.height, box.depth]) * expand / 2.0
        lo = np.array([cx, cy, cz]) - hw
        hi = np.array([cx, cy, cz]) + hw
        inside = np.all((pts_all >= lo) & (pts_all <= hi), axis=1)
        crop = pts_all[inside]
        if len(crop) == 0:
            clusters_out.append(np.zeros((0, 3)))
            centroids.append(np.full(3, np.nan))
            continue
        clusters = euclidean_clusters(crop, tolerance)
        best = crop[clusters[0]] if clusters else crop
        clusters_out.append(best)
        centroids.append(best.mean(axis=0))
    return clusters_out, centroids


def remove_planes(
    cloud: np.ndarray,
    distance_threshold: float = 0.02,
    min_inliers: int = 500,
    max_planes: int = 3,
    seed: int = 0,
) -> np.ndarray:
    """Strip dominant planes (table/floor) from the cloud — the
    organized multi-plane segmentation capability, via iterative RANSAC
    plane fits."""
    rng = np.random.RandomState(seed)
    pts = _finite(np.asarray(cloud, dtype=np.float64))
    for _ in range(max_planes):
        n = len(pts)
        if n < min_inliers:
            break
        best_mask = None
        for _ in range(100):
            idx = rng.choice(n, 3, replace=False)
            p0, p1, p2 = pts[idx]
            normal = np.cross(p1 - p0, p2 - p0)
            nn = np.linalg.norm(normal)
            if nn < 1e-12:
                continue
            normal /= nn
            dist = np.abs((pts - p0) @ normal)
            mask = dist < distance_threshold
            if best_mask is None or mask.sum() > best_mask.sum():
                best_mask = mask
        if best_mask is None or best_mask.sum() < min_inliers:
            break
        pts = pts[~best_mask]
    return pts


def estimate_poses(
    centroids: Sequence[np.ndarray], part_centers: Sequence[np.ndarray]
) -> List[np.ndarray]:
    """4x4 pose per object: translation = cluster centroid, rotation =
    PCA of the part centers (smallest-eigenvector normal convention of
    messagePoses' eigen33 use)."""
    poses: List[np.ndarray] = []
    for centroid, centers in zip(centroids, part_centers):
        pose = np.eye(4)
        pose[:3, 3] = centroid
        pts = _finite(np.asarray(centers, dtype=np.float64))
        if len(pts) >= 3:
            centered = pts - pts.mean(axis=0)
            cov = centered.T @ centered / len(pts)
            _, vecs = np.linalg.eigh(cov)
            rot = vecs[:, ::-1]  # principal axes, major first
            if np.linalg.det(rot) < 0:
                rot[:, 2] *= -1
            pose[:3, :3] = rot
        poses.append(pose)
    return poses


def depth_to_cloud(
    depth: np.ndarray, camera: StereoCameraModel
) -> np.ndarray:
    """Organized depth map -> (H*W, 3) cloud."""
    h, w = depth.shape[:2]
    v, u = np.mgrid[0:h, 0:w]
    z = depth.astype(np.float64)
    x = (u - camera.cx) / camera.fx * z
    y = (v - camera.cy) / camera.fy * z
    return np.stack([x, y, z], axis=-1).reshape(-1, 3)
