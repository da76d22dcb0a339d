"""Model and training visualization.

Python re-expression of the MATLAB visualization stack
(matlab/visualization/): HOG glyph rendering (HOGpicture.m/foldHOG.m),
whole-model part-template mosaics (visualizemodel.m), skeleton and box
overlays (showboxes.m, showskeletons.m), and part-cluster scatter plots
(showpartclusters.m). Everything renders to NumPy images; no GUI
dependency.

A copy of `partsbaseddetector_tpu/visualize_model.py`, so that the
port never imports the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .models.model import Model
from .types import Candidate
from .visualize import part_colors, _draw_rect


def hog_glyph_strokes(glyph_size: int = 20) -> np.ndarray:
    """(9, g, g) oriented line strokes, one per orientation bin
    (HOGpicture.m: bar images rotated through the half circle)."""
    g = glyph_size
    strokes = np.zeros((9, g, g))
    bar = np.zeros((g, g))
    bar[:, g // 2 - 1 : g // 2 + 1] = 1.0
    yy, xx = np.mgrid[0:g, 0:g].astype(np.float64) - (g - 1) / 2.0
    for o in range(9):
        # orientation bin o spans angle o*20 degrees
        ang = -o * np.pi / 9
        ys = np.cos(ang) * yy - np.sin(ang) * xx + (g - 1) / 2.0
        xs = np.sin(ang) * yy + np.cos(ang) * xx + (g - 1) / 2.0
        iy = np.clip(np.round(ys).astype(int), 0, g - 1)
        ix = np.clip(np.round(xs).astype(int), 0, g - 1)
        strokes[o] = bar[iy, ix]
    return strokes


def fold_hog(w: np.ndarray) -> np.ndarray:
    """Collapse the 32 channels to 9 orientation energies
    (foldHOG.m: max(contrast-sensitive pair, insensitive), positives)."""
    f = np.maximum(w[..., :9], 0) + np.maximum(w[..., 9:18], 0) + np.maximum(
        w[..., 18:27], 0
    )
    return f


def hog_picture(w: np.ndarray, glyph_size: int = 20) -> np.ndarray:
    """Render a (fh, fw, 32) filter as an oriented-edge glyph image
    (HOGpicture.m). Returns (fh*g, fw*g) float image."""
    folded = fold_hog(w)
    fh, fw, _ = folded.shape
    strokes = hog_glyph_strokes(glyph_size)
    g = glyph_size
    out = np.zeros((fh * g, fw * g))
    for y in range(fh):
        for x in range(fw):
            cell = (strokes * folded[y, x][:, None, None]).sum(axis=0)
            out[y * g : (y + 1) * g, x * g : (x + 1) * g] = cell
    m = out.max()
    return out / m if m > 0 else out


def visualize_model(
    model: Model, component: int = 0, mixture: int = 0, glyph_size: int = 20
) -> np.ndarray:
    """Mosaic of every part's filter glyph placed at its anchor-derived
    offset (visualizemodel.m). Returns a uint8 grayscale image."""
    c = component
    P = model.nparts(c)
    # accumulate part positions from anchors down the tree (cells)
    pos = np.zeros((P, 2), dtype=np.int64)
    sizes = []
    for p in range(P):
        k = min(mixture, model.nmixtures(c, p) - 1)
        f = model.filters[int(model.filterid[c][p][k])]
        sizes.append(f.shape[:2])
        if p > 0:
            d = int(model.defid[c][p][k])
            ax, ay, _ = model.anchors[d]
            par = int(model.parentid[c][p])
            pos[p] = pos[par] + [ax, ay]
    mins = pos.min(axis=0)
    pos -= mins
    ext_y = max(pos[p][1] + sizes[p][0] for p in range(P)) + 1
    ext_x = max(pos[p][0] + sizes[p][1] for p in range(P)) + 1
    g = glyph_size
    canvas = np.zeros((ext_y * g, ext_x * g))
    for p in range(P):
        k = min(mixture, model.nmixtures(c, p) - 1)
        f = model.filters[int(model.filterid[c][p][k])]
        pic = hog_picture(f, g)
        y0, x0 = pos[p][1] * g, pos[p][0] * g
        region = canvas[y0 : y0 + pic.shape[0], x0 : x0 + pic.shape[1]]
        np.maximum(region, pic[: region.shape[0], : region.shape[1]], out=region)
    return (canvas * 255).astype(np.uint8)


def show_boxes(
    im: np.ndarray, candidate: Candidate, thickness: int = 2
) -> np.ndarray:
    """Per-part colored boxes (showboxes.m)."""
    canvas = np.ascontiguousarray(im, dtype=np.uint8).copy()
    cols = part_colors(len(candidate.parts))
    for p, box in enumerate(candidate.parts):
        _draw_rect(canvas, box, cols[p], thickness)
    return canvas


def show_skeleton(
    im: np.ndarray, candidate: Candidate, parentid: np.ndarray, thickness: int = 2
) -> np.ndarray:
    """Stick-figure rendering: line segments between part centers and
    their parents (showskeletons.m)."""
    canvas = np.ascontiguousarray(im, dtype=np.uint8).copy()
    centers = np.stack(
        [
            0.5 * (candidate.parts[:, 0] + candidate.parts[:, 2]),
            0.5 * (candidate.parts[:, 1] + candidate.parts[:, 3]),
        ],
        axis=1,
    )
    cols = part_colors(len(centers))
    h, w = canvas.shape[:2]
    for p in range(1, len(centers)):
        x0, y0 = centers[int(parentid[p])]
        x1, y1 = centers[p]
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
        xs = np.linspace(x0, x1, n).astype(int)
        ys = np.linspace(y0, y1, n).astype(int)
        ok = (xs >= 0) & (xs < w - thickness) & (ys >= 0) & (ys < h - thickness)
        for t in range(thickness):
            canvas[ys[ok] + t, xs[ok]] = cols[p]
            canvas[ys[ok], xs[ok] + t] = cols[p]
    return canvas


def show_part_clusters(
    deffeat: Sequence[np.ndarray], idx: Sequence[np.ndarray], size: int = 400
) -> np.ndarray:
    """Scatter image of relative part offsets colored by cluster
    (showpartclusters.m)."""
    P = len(deffeat)
    cols = min(P, 6)
    rows = (P + cols - 1) // cols
    canvas = np.zeros((rows * size, cols * size, 3), dtype=np.uint8)
    for p in range(P):
        pts = deffeat[p]
        span = max(np.abs(pts).max(), 1e-6)
        cy, cx = divmod(p, cols)
        palette = part_colors(int(idx[p].max()) + 1)
        for (x, y), k in zip(pts, idx[p]):
            px = int((x / span * 0.45 + 0.5) * (size - 1)) + cx * size
            py = int((y / span * 0.45 + 0.5) * (size - 1)) + cy * size
            canvas[
                max(py - 1, 0) : py + 2, max(px - 1, 0) : px + 2
            ] = palette[int(k)]
    return canvas


def visualize_hog(feat: np.ndarray, glyph_size: int = 20) -> np.ndarray:
    """Glyph rendering of a feature map (visualizeHOG.m)."""
    return (hog_picture(feat, glyph_size) * 255).astype(np.uint8)
