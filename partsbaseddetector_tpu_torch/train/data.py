"""Training data preparation: keypoints -> part boxes, cropping,
warping.

Python re-expressions of matlab/learning/{pointtobox.m, croppos.m,
warppos.m, subarray.m}. Positive examples are dicts:
  {'im': (H, W, 3) array or path, 'points': (P, 2) keypoints}
and gain 'boxes': (P, 4) per-part boxes after point_to_box.

A NumPy copy of `partsbaseddetector_tpu/train/data.py`,
kept verbatim so that the port never imports the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops import reference


def _imread(ex) -> np.ndarray:
    im = ex["im"]
    if isinstance(im, str):
        from PIL import Image

        im = np.asarray(Image.open(im).convert("RGB"), dtype=np.float64)
    im = np.asarray(im, dtype=np.float64)
    if im.ndim == 2:
        im = np.repeat(im[:, :, None], 3, axis=2)
    return im


def point_to_box(
    positives: Sequence[Dict], pa: Sequence[int]
) -> List[Dict]:
    """Keypoints -> square part boxes sized from limb-length statistics
    (pointtobox.m): per-part median length ratio r_p vs the first limb,
    per-example box side = 85th percentile of len/r."""
    n = len(positives)
    p_total = len(pa)
    lengths = np.zeros((n, p_total - 1))
    for i, ex in enumerate(positives):
        pts = np.asarray(ex["points"], dtype=np.float64)
        for p in range(1, p_total):
            lengths[i, p - 1] = np.linalg.norm(pts[p, :2] - pts[pa[p], :2])

    r = np.zeros(p_total - 1)
    for p in range(p_total - 1):
        with np.errstate(divide="ignore"):
            ratio = np.log(lengths[:, p]) - np.log(lengths[:, 0])
        r[p] = np.exp(np.median(ratio[np.isfinite(ratio)]))

    out = []
    for i, ex in enumerate(positives):
        ratio = lengths[i] / r
        side = float(np.quantile(ratio, 0.85))
        pts = np.asarray(ex["points"], dtype=np.float64)
        boxes = np.stack(
            [
                pts[:, 0] - side / 2,
                pts[:, 1] - side / 2,
                pts[:, 0] + side / 2,
                pts[:, 1] + side / 2,
            ],
            axis=1,
        )
        ex = dict(ex)
        ex["boxes"] = boxes
        out.append(ex)
    return out


def crop_positive(ex: Dict) -> Dict:
    """Crop the image around the part boxes with half-extent padding to
    speed up latent search (croppos.m). 0-based coordinates."""
    im = _imread(ex)
    boxes = np.asarray(ex["boxes"], dtype=np.float64)
    x1, y1 = boxes[:, 0].min(), boxes[:, 1].min()
    x2, y2 = boxes[:, 2].max(), boxes[:, 3].max()
    pad = 0.5 * ((x2 - x1 + 1) + (y2 - y1 + 1))
    cx1 = max(0, int(round(x1 - pad)))
    cy1 = max(0, int(round(y1 - pad)))
    cx2 = min(im.shape[1], int(round(x2 + pad)) + 1)
    cy2 = min(im.shape[0], int(round(y2 + pad)) + 1)
    out = dict(ex)
    out["im"] = im[cy1:cy2, cx1:cx2, :]
    nb = boxes.copy()
    nb[:, [0, 2]] -= cx1
    nb[:, [1, 3]] -= cy1
    out["boxes"] = nb
    if "points" in ex:
        pts = np.asarray(ex["points"], dtype=np.float64).copy()
        pts[:, 0] -= cx1
        pts[:, 1] -= cy1
        out["points"] = pts
    return out


def subarray(
    im: np.ndarray, y1: int, y2: int, x1: int, x2: int, pad_mode: bool = True
) -> np.ndarray:
    """Inclusive-slice with edge replication outside bounds
    (subarray.m)."""
    ys = np.clip(np.arange(y1, y2 + 1), 0, im.shape[0] - 1)
    xs = np.clip(np.arange(x1, x2 + 1), 0, im.shape[1] - 1)
    return im[np.ix_(ys, xs)]


def warp_positive(
    ex: Dict, box: np.ndarray, fsize: Tuple[int, int], sbin: int
) -> np.ndarray:
    """Extract and resample one part box to the filter's pixel size with
    one cell of context (warppos.m). Returns ((fh+2)*sbin, (fw+2)*sbin, 3)."""
    im = _imread(ex)
    fh, fw = fsize
    pixels = np.array([fh * sbin, fw * sbin], dtype=np.float64)
    x1, y1, x2, y2 = box
    h, w = y2 - y1 + 1, x2 - x1 + 1
    padx = sbin * w / pixels[1]
    pady = sbin * h / pixels[0]
    ix1 = int(round(x1 - padx))
    ix2 = int(round(x2 + padx))
    iy1 = int(round(y1 - pady))
    iy2 = int(round(y2 + pady))
    window = subarray(im, iy1, iy2, ix1, ix2)
    target = ((fh + 2) * sbin, (fw + 2) * sbin)
    from PIL import Image

    out = np.zeros((*target, 3))
    for c in range(3):
        out[:, :, c] = np.asarray(
            Image.fromarray(window[:, :, c].astype(np.float32), mode="F").resize(
                (target[1], target[0]), Image.BILINEAR
            )
        )
    return out


def warp_positive_feature(
    ex: Dict, box: np.ndarray, fsize: Tuple[int, int], sbin: int
) -> np.ndarray:
    """HOG of the warped window — the fixed positive feature block for
    the warped-SVM stage (train.m poswarp)."""
    warped = warp_positive(ex, box, fsize, sbin)
    feat = reference.hog(warped, sbin)
    assert feat.shape[:2] == fsize, (feat.shape, fsize)
    return feat
