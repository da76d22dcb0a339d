"""RGB-D extensions: depth-consistency candidate filtering, per-scale
response gating, 3-D bounding boxes (Rect3), depth-consistency
rescoring.

A copy of `partsbaseddetector_tpu/depth.py` for the torch port, over
the port's own PackedModel and Candidate, in NumPy; the box medians of
2-D float32 maps take the port's native C++ helper when it builds
(`native.box_medians`), as the JAX package's copy does.

Capabilities of the reference's depth pathway, including the parts it
left incomplete (SURVEY.md §7):
  - filter_candidates_by_depth: keep candidates whose connected parts'
    median depths are consistent (src/SearchSpacePruning.cpp:73-95;
    the call site is commented out in the C++ detect(), implemented
    here as a first-class option of detect(im, depth));
  - filter_responses_by_depth: per-scale plausible-depth gating — the
    reference computes the plausible depth and then discards it
    (src/SearchSpacePruning.cpp:47-70); we implement the intended
    masking;
  - bounding_box_3d: median + gradient-walk depth interval around the
    candidate (include/Candidate.hpp:140-216);
  - DepthConsistency rescoring (the reference's DepthConsistency class
    is an empty stub — include/DepthConsistency.hpp:49-55): a working
    per-candidate depth-coherence score.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .models.model import PackedModel
from .types import Candidate


@dataclasses.dataclass
class Rect3:
    """3-D axis-aligned box (ref: include/Rect3.hpp)."""

    x: float
    y: float
    z: float
    width: float
    height: float
    depth: float

    @property
    def tl(self) -> Tuple[float, float, float]:
        return (self.x, self.y, self.z)

    @property
    def br(self) -> Tuple[float, float, float]:
        return (self.x + self.width, self.y + self.height, self.z + self.depth)

    def volume(self) -> float:
        return self.width * self.height * self.depth

    def contains(self, pt) -> bool:
        x, y, z = pt
        bx, by, bz = self.br
        return (
            self.x <= x < bx and self.y <= y < by and self.z <= z < bz
        )

    def centroid(self) -> Tuple[float, float, float]:
        return (
            self.x + self.width / 2,
            self.y + self.height / 2,
            self.z + self.depth / 2,
        )

    def intersection(self, o: "Rect3") -> "Rect3":
        x1, y1, z1 = max(self.x, o.x), max(self.y, o.y), max(self.z, o.z)
        x2 = min(self.x + self.width, o.x + o.width)
        y2 = min(self.y + self.height, o.y + o.height)
        z2 = min(self.z + self.depth, o.z + o.depth)
        return Rect3(x1, y1, z1, max(x2 - x1, 0), max(y2 - y1, 0), max(z2 - z1, 0))

    def convex_hull(self, o: "Rect3") -> "Rect3":
        x1, y1, z1 = min(self.x, o.x), min(self.y, o.y), min(self.z, o.z)
        x2 = max(self.x + self.width, o.x + o.width)
        y2 = max(self.y + self.height, o.y + o.height)
        z2 = max(self.z + self.depth, o.z + o.depth)
        return Rect3(x1, y1, z1, x2 - x1, y2 - y1, z2 - z1)


def _clip_box(box, h, w):
    x1 = int(max(box[0], 0))
    y1 = int(max(box[1], 0))
    x2 = int(min(box[2] + 1, w))
    y2 = int(min(box[3] + 1, h))
    return x1, y1, x2, y2


def _median_depth(depth: np.ndarray, box) -> float:
    h, w = depth.shape[:2]
    x1, y1, x2, y2 = _clip_box(box, h, w)
    if x2 <= x1 or y2 <= y1:
        return 0.0
    region = depth[y1:y2, x1:x2]
    vals = region[np.isfinite(region)]
    if vals.size == 0:
        return 0.0
    # the reference takes the element at index n/2 via nth_element — the
    # UPPER middle for even counts, no averaging (include/Math.hpp:62-72);
    # np.partition reproduces it exactly (and skips np.median's average)
    k = vals.size // 2
    return float(np.partition(vals, k)[k])


def _batch_medians(depth: np.ndarray, boxes: List) -> np.ndarray:
    """Medians for many boxes in one call: 2-D float32 maps go to the
    native helper (`native.box_medians`, the identical nth_element-at-n/2
    value for every box in one pass) when it is available; every other
    case takes the NumPy loop."""
    if not len(boxes):
        return np.zeros(0, dtype=np.float64)
    if depth.ndim == 2 and depth.dtype == np.float32:
        from . import native

        if native.available():
            return native.box_medians(depth, np.asarray(boxes, np.float64))
    return np.array([_median_depth(depth, b) for b in boxes], dtype=np.float64)


def _anchor_norms(comp) -> np.ndarray:
    """||anchor|| per non-root part (parts 1..nparts-1)."""
    a = comp.anchor[1:, 0, :2].astype(np.float64)
    return np.linalg.norm(a, axis=1)


def filter_candidates_by_depth(
    packed: PackedModel,
    candidates: List[Candidate],
    depth: np.ndarray,
    zfactor: float = 0.5,
) -> List[Candidate]:
    """Keep candidates whose child/parent median part depths differ by
    less than ||anchor|| * zfactor (src/SearchSpacePruning.cpp:73-95).
    Zero/NaN medians are treated as unknown and pass."""
    if not candidates:
        return []
    # one median per (candidate, part), all in one batched call
    boxes: List = []
    for cand in candidates:
        comp = packed.components[cand.component]
        boxes.extend(cand.parts[p] for p in range(comp.nparts))
    med_flat = _batch_medians(depth, boxes)

    out: List[Candidate] = []
    norms = {}
    off = 0
    for cand in candidates:
        comp = packed.components[cand.component]
        med = med_flat[off : off + comp.nparts]
        off += comp.nparts
        if cand.component not in norms:
            norms[cand.component] = _anchor_norms(comp)
        cmed = med[1:]
        pmed = med[comp.parentid[1:].astype(np.int64)]
        bad = (
            (cmed > 0)
            & (pmed > 0)
            & (np.abs(cmed - pmed) > norms[cand.component] * zfactor)
        )
        if not bad.any():
            out.append(cand)
    return out


def depth_consistency_score(
    packed: PackedModel, cand: Candidate, depth: np.ndarray
) -> float:
    """Working DepthConsistency rescoring (the reference class is an
    empty stub): mean absolute child-parent depth gap normalized by
    anchor length; 0 = perfectly rigid, larger = less consistent."""
    comp = packed.components[cand.component]
    med = _batch_medians(
        depth, [cand.parts[p] for p in range(comp.nparts)]
    )
    cmed = med[1:]
    pmed = med[comp.parentid[1:].astype(np.int64)]
    norms = np.maximum(_anchor_norms(comp), 1e-6)
    sel = (cmed > 0) & (pmed > 0)
    if not sel.any():
        return 0.0
    return float(np.mean(np.abs(cmed - pmed)[sel] / norms[sel]))


@dataclasses.dataclass(frozen=True)
class DepthGate:
    """Parameters of per-scale plausible-depth response gating — the
    *intended* behavior of filterResponseByDepth
    (src/SearchSpacePruning.cpp:47-70: computes Z = fx*X/scale per scale
    and then discards it; both call sites in the C++ detect() are
    commented out). An object of real width `object_width_m` imaged by a
    camera of focal length `fx` appears at pyramid scale `scale` only
    when it lies near depth Z = fx*object_width_m/scale; response cells
    whose local depth disagrees by more than tolerance*Z are masked to
    -inf before the DP, so no part placement can land on them."""

    object_width_m: float
    fx: float
    tolerance: float = 0.5


def gate_sample_indices(
    n: int, off: int, box_scale: float, im_extent: int, d_extent: int
) -> np.ndarray:
    """Depth-map sample index per response-grid coordinate (one axis).

    Grid cell i maps to image pixel (i + off + 0.5) * box_scale (off is
    the response grid's box origin: -1 in cpp border mode, -padx/-pady
    in matlab mode — the same offsets backtrack uses for boxes), then
    into depth-map coordinates by the depth/image size ratio, clamped.
    Shared by the host predictor (depth_level_mask) and the device gate
    (pipeline.depth_response_masks) so the two agree bit-for-bit."""
    px = (np.arange(n, dtype=np.float64) + off + 0.5) * box_scale
    idx = np.floor(px * (d_extent / float(im_extent))).astype(np.int32)
    return np.clip(idx, 0, d_extent - 1)


def gate_plausible(d: np.ndarray, z: float, tolerance: float) -> np.ndarray:
    """True where a sampled depth is plausible for expected depth z:
    within tolerance*z, or unknown (<= 0 / non-finite) which passes."""
    return (
        (np.abs(d - z) <= tolerance * z) | (d <= 0) | ~np.isfinite(d)
    )


def depth_level_mask(
    depth: np.ndarray,
    grid_shape: Tuple[int, int],
    box_scale: float,
    off_x: int,
    off_y: int,
    im_shape: Tuple[int, int],
    gate: DepthGate,
) -> np.ndarray:
    """Host predictor for one pyramid level's plausible-depth gate:
    (H, W) bool over the level's response grid. The device pipeline
    (pipeline.depth_response_masks) computes the identical mask."""
    h, w = grid_shape
    iy = gate_sample_indices(h, off_y, box_scale, im_shape[0], depth.shape[0])
    ix = gate_sample_indices(w, off_x, box_scale, im_shape[1], depth.shape[1])
    d = depth[iy[:, None], ix[None, :]].astype(np.float64)
    z = gate.fx * gate.object_width_m / box_scale
    return gate_plausible(d, z, gate.tolerance)


def plausible_depth_mask(
    depth: np.ndarray,
    resp_shape: Tuple[int, int],
    scale: float,
    object_width_m: float,
    fx: float,
    tolerance: float = 0.5,
) -> np.ndarray:
    """Per-scale plausible-depth response gate — the *intended* behavior
    of filterResponseByDepth (src/SearchSpacePruning.cpp:47-70 computes
    Z = fx*X/scale and discards it). A part of real width X imaged at
    pyramid scale `scale` must lie near depth Z = fx*X/scale; responses
    whose local depth disagrees by more than tolerance*Z are masked.

    Returns a bool (H, W) mask aligned to the response grid."""
    from PIL import Image

    z_expected = fx * object_width_m / scale
    d = np.asarray(
        Image.fromarray(depth.astype(np.float32)).resize(
            (resp_shape[1], resp_shape[0]), Image.NEAREST
        )
    )
    ok = np.abs(d - z_expected) <= tolerance * z_expected
    ok |= ~np.isfinite(d) | (d <= 0)  # unknown depth passes
    return ok


def bounding_box_3d(
    im_shape: Tuple[int, int], depth: np.ndarray, cand: Candidate
) -> Rect3:
    """Approximate 3-D box: pool part depths, take the median, walk a
    DoG-smoothed depth profile outward until the gradient exceeds 0.035
    (include/Candidate.hpp:140-216)."""
    h, w = im_shape
    dh, dw = depth.shape[:2]
    sx, sy = dw / w, dh / h

    points: List[float] = []
    boxes = [cand.parts[p] for p in range(len(cand.parts))]
    boxes.append(cand.bounding_box_norm())
    for box in boxes:
        x1, y1, x2, y2 = _clip_box(
            [box[0] * sx, box[1] * sy, box[2] * sx, box[3] * sy], dh, dw
        )
        if x2 <= x1 or y2 <= y1:
            continue
        region = depth[y1:y2, x1:x2].ravel()
        points.extend(region[np.isfinite(region) & (region != 0)].tolist())
    bb = cand.bounding_box()
    if not points:
        return Rect3(np.nan, np.nan, np.nan, 0, 0, 0)

    pts = np.sort(np.asarray(points, dtype=np.float64))
    # resample to 400 samples (Candidate.hpp:186)
    m = 400
    idx = np.linspace(0, len(pts) - 1, m)
    pts = np.interp(idx, np.arange(len(pts)), pts)

    # derivative-of-Gaussian smoothing of the profile (Candidate.hpp:194-198)
    g = np.exp(-0.5 * ((np.arange(35) - 17) / 4.0) ** 2)
    g /= g.sum()
    dog = np.convolve(g, [-1, 0, 1], mode="same")
    dpts = np.convolve(pts, dog, mode="same")

    mid = m // 2
    dmin = dmax = mid
    for i in range(mid, m):
        if abs(dpts[i]) > 0.035:
            break
        dmax = i
    for i in range(mid, -1, -1):
        if abs(dpts[i]) > 0.035:
            break
        dmin = i
    z1, z2 = pts[dmin], pts[dmax]
    return Rect3(bb[0], bb[1], z1, bb[2] - bb[0], bb[3] - bb[1], z2 - z1)


class StereoCameraModel:
    """Slim camera model for non-ROS users (the reference's version is an
    empty stub — include/StereoCameraModel.hpp:42-49). Holds intrinsics
    and projects pixels to rays / 3-D points."""

    def __init__(self, fx: float, fy: float, cx: float, cy: float):
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy

    def project_pixel_to_3d_ray(self, u: float, v: float) -> np.ndarray:
        ray = np.array([(u - self.cx) / self.fx, (v - self.cy) / self.fy, 1.0])
        return ray / ray[2]

    def project_pixel_at_depth(self, u: float, v: float, z: float) -> np.ndarray:
        return self.project_pixel_to_3d_ray(u, v) * z
