"""Placement -> structural feature vector, and the score-reconstruction
invariant.

The detection score is linear in the weights: for a placement (level,
per-part grid positions and mixtures),

    score = sum_p bias_p + sum_p w_def_p . (-[dx^2 dx dy^2 dy])
          + sum_p filter_p . hog_patch_p

(detect.m:255-341: backtrack block writing + defvector). This module
assembles that feature vector against a ParamLayout so that

    w . phi(placement) == root DP score            (detect.m:139-146)

— the reference's crucial training-time DEBUG assertion, promoted here
to a first-class invariant test of the whole conv+DT+DP chain — and so
the latent SSVM trainer (train/latent.py) can write examples.

A NumPy copy of `partsbaseddetector_tpu/train/features.py`,
kept verbatim so that the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..models.model import Model
from .layout import ParamLayout


@dataclasses.dataclass
class Placement:
    """One full-tree detection in pyramid-grid coordinates (0-based,
    padded response grid). `level` is the root's level; parts with
    octave offsets (anchor ds != 0) live at level - ds*interval and
    their (xs, ys) are in that finer grid."""

    level: int
    component: int
    xs: np.ndarray  # (P,)
    ys: np.ndarray  # (P,)
    mixtures: np.ndarray  # (P,)
    score: float = 0.0


def part_levels(model: Model, c: int, level: int) -> np.ndarray:
    """Per-part pyramid level given the root level (accumulated octave
    offsets, detect_fast.m:93-105)."""
    P = model.nparts(c)
    ds = np.zeros(P, dtype=np.int64)
    for p in range(1, P):
        d = int(model.defid[c][p][0])
        ds[p] = model.anchors[d][2] + ds[int(model.parentid[c][p])]
    return level - ds * model.interval


def def_feature(
    model: Model, c: int, p: int, px: int, py: int, x: int, y: int, mix: int
) -> np.ndarray:
    """-[dx^2 dx dy^2 dy] with the anchored/virtual-padded probe
    (detect.m:330-337): probe = parent*2^ds + anchor - (2^ds - 1)*pad in
    the child's grid."""
    d = int(model.defid[c][p][mix])
    ax, ay, ds = model.anchors[d]
    step = 1 << int(ds)
    pady, padx = model.pad()
    probex = px * step + int(ax) - (step - 1) * padx
    probey = py * step + int(ay) - (step - 1) * pady
    dx = probex - x
    dy = probey - y
    return -np.array([dx * dx, dx, dy * dy, dy], dtype=np.float64)


def placement_feature(
    model: Model,
    layout: ParamLayout,
    feats: List[np.ndarray],
    placement: Placement,
) -> np.ndarray:
    """Dense phi(placement) over the flat layout. feats are the padded
    pyramid features (reference_pipeline.feature_pyramid)."""
    c = placement.component
    phi = np.zeros(layout.length)
    levels = part_levels(model, c, placement.level)
    par = model.parentid[c]
    for p in range(model.nparts(c)):
        feat = feats[int(levels[p])]
        x, y, mix = (
            int(placement.xs[p]),
            int(placement.ys[p]),
            int(placement.mixtures[p]),
        )
        # bias indicator
        if p == 0:
            bidx = int(model.biasid[c][0][0, mix])
        else:
            pmix = int(placement.mixtures[par[p]])
            bidx = int(model.biasid[c][p][pmix, mix])
        phi[layout.bias_off[bidx]] += 1.0

        # deformation feature
        if p > 0:
            px, py = int(placement.xs[par[p]]), int(placement.ys[par[p]])
            d = int(model.defid[c][p][mix])
            phi[layout.def_off[d] : layout.def_off[d] + 4] += def_feature(
                model, c, p, px, py, x, y, mix
            )

        # HOG patch under the part filter
        fidx = int(model.filterid[c][p][mix])
        fh, fw, _ = model.filters[fidx].shape
        patch = feat[y : y + fh, x : x + fw, :]
        off = layout.filter_off[fidx]
        phi[off : off + patch.size] += patch.ravel()
    return phi


def reconstruct_score(
    model: Model,
    layout: ParamLayout,
    feats: List[np.ndarray],
    placement: Placement,
) -> float:
    """w . phi — must equal the DP root score to ~1e-5."""
    w = layout.model_to_vec(model)
    return float(w @ placement_feature(model, layout, feats, placement))


def detections_to_placements(detections: List[dict]) -> List[Placement]:
    """Adapt reference_pipeline.detect_reference output (which carries
    grid coordinates when requested) to Placement records."""
    out = []
    for d in detections:
        out.append(
            Placement(
                level=d["level"],
                component=d["component"],
                xs=np.asarray(d["xs"]),
                ys=np.asarray(d["ys"]),
                mixtures=np.asarray(d["mixtures"]),
                score=d["score"],
            )
        )
    return out
