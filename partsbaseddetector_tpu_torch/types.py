"""Core result types for the detector.

Mirrors the capability of the reference `include/Candidate.hpp` (part
boxes + confidences + component id, sorting, bounding boxes, NMS, masks)
as plain NumPy-backed Python objects. Device code returns dense padded
tensors; these types are the host-side view.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Candidate:
    """A single detection: one box per part of the model tree.

    parts: (P, 4) float array of [x1, y1, x2, y2] boxes (x2/y2 inclusive,
        as in the reference), part 0 is the tree root.
    confidence: (P,) float array; reference semantics keep the root score
        in confidence[0] and 0.0 for child parts
        (ref: src/DynamicProgram.cpp:241-244).
    component: index of the model component that produced the detection.
    """

    parts: np.ndarray
    confidence: np.ndarray
    component: int = 0
    # (P,) int32 per-part appearance-mixture argmaxes (Ik backtrack);
    # None when produced by a path that does not track them
    mixtures: Optional[np.ndarray] = None

    @property
    def score(self) -> float:
        """Root score, used for ordering (ref: include/Candidate.hpp:74)."""
        return float(self.confidence[0]) if self.confidence.size else -np.inf

    def resize(self, factor: float) -> "Candidate":
        """Rescale all part boxes about the origin (ref: Candidate.hpp:82-89)."""
        return Candidate(
            self.parts * factor, self.confidence, self.component, self.mixtures
        )

    def bounding_box(self) -> np.ndarray:
        """Hull of all part boxes (ref: Candidate.hpp:105-111). Returns [x1,y1,x2,y2]."""
        p = self.parts
        return np.array(
            [p[:, 0].min(), p[:, 1].min(), p[:, 2].max(), p[:, 3].max()],
            dtype=np.float64,
        )

    def bounding_box_norm(self) -> np.ndarray:
        """Mean +/- 1.5 sigma box of part centroids (ref: Candidate.hpp:117-130)."""
        cx = 0.5 * (self.parts[:, 0] + self.parts[:, 2])
        cy = 0.5 * (self.parts[:, 1] + self.parts[:, 3])
        # The reference casts centroids to int before the statistics.
        cx = np.floor(cx).astype(np.int64)
        cy = np.floor(cy).astype(np.int64)
        xm, xs = cx.mean(), cx.std()
        ym, ys = cy.mean(), cy.std()
        x1, y1 = xm - 1.5 * xs, ym - 1.5 * ys
        return np.array([x1, y1, x1 + 3 * xs, y1 + 3 * ys], dtype=np.float64)

    @staticmethod
    def sort(candidates: List["Candidate"]) -> List["Candidate"]:
        """Stable sort, best root score first (ref: Candidate.hpp:91-99)."""
        return sorted(candidates, key=lambda c: -c.score)

    @staticmethod
    def non_maxima_suppression(
        image_size: Tuple[int, int],
        candidates: List["Candidate"],
        overlap: float = 0.0,
    ) -> List["Candidate"]:
        """Greedy paint-based NMS (ref: Candidate.hpp:277-304).

        image_size is (height, width). Keeps a candidate if the fraction
        of its (clipped) bounding box already painted is <= overlap,
        then paints the box. Order-sensitive: callers sort first.
        """
        h, w = image_size
        scratch = np.zeros((h, w), dtype=np.uint8)
        keep: List[Candidate] = []
        for cand in candidates:
            x1, y1, x2, y2 = cand.bounding_box()
            # Rect & bounds intersection with integer truncation like cv::Rect.
            ix1, iy1 = max(int(x1), 0), max(int(y1), 0)
            ix2, iy2 = min(int(x2), w), min(int(y2), h)
            bw, bh = ix2 - ix1, iy2 - iy1
            if bw <= 0 or bh <= 0:
                continue
            painted = float(scratch[iy1:iy2, ix1:ix2].sum())
            if painted / (bw * bh) > overlap:
                continue
            scratch[iy1:iy2, ix1:ix2] = 1
            keep.append(cand)
        return keep

    @staticmethod
    def mask(
        image_size: Tuple[int, int], candidates: Sequence["Candidate"]
    ) -> np.ndarray:
        """Labeled instance mask: pixel==n+1 marks candidate n
        (ref: Candidate.hpp:320-331)."""
        h, w = image_size
        out = np.zeros((h, w), dtype=np.uint8)
        for n, cand in enumerate(candidates):
            x1, y1, x2, y2 = cand.bounding_box()
            ix1, iy1 = max(int(x1), 0), max(int(y1), 0)
            ix2, iy2 = min(int(x2), w), min(int(y2), h)
            if ix2 <= ix1 or iy2 <= iy1:
                continue
            region = out[iy1:iy2, ix1:ix2]
            region[region == 0] = n + 1
        return out


@dataclasses.dataclass
class DetectionResult:
    """Dense device-side detection output for one image.

    boxes: (max_det, P_max, 4) part boxes in image coordinates (part
        dim padded across components).
    scores: (max_det,) root scores.
    components: (max_det,) component indices.
    valid: (max_det,) bool mask of real detections.
    nparts_by_component: true part count per component (trims padding).
    """

    boxes: np.ndarray
    scores: np.ndarray
    components: np.ndarray
    valid: np.ndarray
    nparts_by_component: Optional[Sequence[int]] = None
    # (max_det, P_max) int32 per-part mixture (appearance-type) argmaxes
    # — the DP's Ik backtrack output (detect_fast.m:144-177); optional
    # because host-side constructors (e.g. CPU twin) may omit it
    mixtures: Optional[np.ndarray] = None
    # (max_det,) bool device-side depth-consistency keep mask
    # (ops/depth_device.py), set when the detector ran its device depth
    # filter; detect() ANDs it into valid before candidate assembly
    depth_keep: Optional[np.ndarray] = None

    def to_candidates(self) -> List[Candidate]:
        out: List[Candidate] = []
        p_max = self.boxes.shape[1]
        for i in np.flatnonzero(self.valid):
            comp = int(self.components[i])
            nparts = (
                int(self.nparts_by_component[comp])
                if self.nparts_by_component is not None
                else p_max
            )
            conf = np.zeros(nparts, dtype=np.float32)
            conf[0] = self.scores[i]
            out.append(
                Candidate(
                    np.asarray(self.boxes[i, :nparts], dtype=np.float64),
                    conf,
                    comp,
                    mixtures=(
                        np.asarray(self.mixtures[i, :nparts], dtype=np.int32)
                        if self.mixtures is not None
                        else None
                    ),
                )
            )
        return out
