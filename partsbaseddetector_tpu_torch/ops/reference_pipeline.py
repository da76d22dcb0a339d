"""End-to-end NumPy reference detector (the semantic golden).

A loop-level implementation of the full inference pipeline with the
authoritative MATLAB-path semantics (detection/detect_fast.m +
featpyramid.m): exact-size ragged pyramid, per-level padded features
with the boundary occlusion channel, per-filter valid correlations,
per-mixture shifted distance transforms, (L, K) bias mixture-max
message passing, root bias + mixture max, thresholded vectorized
backtracking with (x - padx) * scale box geometry.

Used by tests as the golden for the batched TPU pipeline and by
bench.py as the CPU baseline proxy. Double precision throughout.

A NumPy copy of `partsbaseddetector_tpu/ops/reference_pipeline.py`,
kept verbatim so that the port never imports the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..models.model import Model
from . import reference


def same_conv_cpp(feat: np.ndarray, filt: np.ndarray, kernels=reference) -> np.ndarray:
    """'Same'-size correlation with the C++ engine's border semantics
    (src/SpatialConvolutionEngine.cpp:133-158): channels 0..C-2 see a
    zero constant border, the occlusion channel a ONE border; the kernel
    anchor is cv's (fw//2, fh//2). Output size == feat size."""
    fh, fw, _ = filt.shape
    ay, ax = fh // 2, fw // 2
    padded = np.pad(
        feat, ((ay, fh - 1 - ay), (ax, fw - 1 - ax), (0, 0)), mode="constant"
    )
    padded[..., -1] = np.pad(
        feat[..., -1],
        ((ay, fh - 1 - ay), (ax, fw - 1 - ax)),
        mode="constant",
        constant_values=1.0,
    )
    return kernels.fconv_valid(np.ascontiguousarray(padded), filt)


def feature_pyramid(
    im: np.ndarray, model: Model, kernels=reference, pad: bool = True
):
    """Exact ragged pyramid of padded HOG features.

    Returns (feats, box_scales, padx, pady); feats[i] is
    (fh + 2*(pady+1), fw + 2*(padx+1), flen) with the occlusion channel
    set to 1 on the pad frame (featpyramid.m:36-45). pad=False skips the
    padding (the C++ demo path has none — src/HOGFeatures.cpp:147-148
    commented out)."""
    h, w = im.shape[:2]
    sc = 2.0 ** (1.0 / model.interval)
    nscales = 1 + int(
        math.floor(math.log(min(h, w) / (5.0 * model.sbin)) / math.log(sc))
    )
    pady, padx = model.pad()

    feats: List[Optional[np.ndarray]] = [None] * nscales
    box_scales = np.zeros(nscales)
    for i in range(min(model.interval, nscales)):
        scaled = kernels.resize(im, 1.0 / sc**i) if i > 0 else im.astype(np.float64)
        feats[i] = kernels.hog(scaled, model.sbin)
        box_scales[i] = model.sbin * sc**i
        j = i + model.interval
        while j < nscales:
            scaled = kernels.reduce(scaled)
            feats[j] = kernels.hog(scaled, model.sbin)
            box_scales[j] = 2.0 * box_scales[j - model.interval]
            j += model.interval

    if not pad:
        return feats, box_scales, 0, 0
    py, px = pady + 1, padx + 1
    for i in range(nscales):
        f = np.pad(feats[i], ((py, py), (px, px), (0, 0)))
        f[:py, :, -1] = 1.0
        f[-py:, :, -1] = 1.0
        f[:, :px, -1] = 1.0
        f[:, -px:, -1] = 1.0
        feats[i] = f
    return feats, box_scales, padx, pady


def overlap_mask(
    resp_shape: Tuple[int, int],
    fsize: Tuple[int, int],
    box_scale: float,
    padx: int,
    pady: int,
    bbox: np.ndarray,
    overlap: float,
) -> np.ndarray:
    """Bool mask of grid positions whose filter window has IoU >= overlap
    with bbox (detect.m:338-375 testoverlap, 0-based)."""
    ny, nx = resp_shape
    fh, fw = fsize
    x1 = (np.arange(nx) - padx) * box_scale
    y1 = (np.arange(ny) - pady) * box_scale
    x2 = x1 + fw * box_scale - 1
    y2 = y1 + fh * box_scale - 1
    bx1, by1, bx2, by2 = bbox
    w = np.clip(np.minimum(x2, bx2) - np.maximum(x1, bx1) + 1, 0, None)
    h = np.clip(np.minimum(y2, by2) - np.maximum(y1, by1) + 1, 0, None)
    inter = h[:, None] * w[None, :]
    area = (y2 - y1 + 1)[:, None] * (x2 - x1 + 1)[None, :]
    barea = (by2 - by1 + 1) * (bx2 - bx1 + 1)
    return inter / (area + barea - inter) >= overlap


def detect_reference(
    im: np.ndarray,
    model: Model,
    thresh: Optional[float] = None,
    part_boxes: Optional[np.ndarray] = None,
    overlap: float = 0.7,
    fixed_mixtures: Optional[np.ndarray] = None,
    kernels=reference,
    border_mode: str = "matlab",
    level_masks: Optional[List[np.ndarray]] = None,
) -> List[dict]:
    """Full-pipeline reference detection.

    Returns a list of dicts {boxes (P, 4), score, component, level,
    mixtures (P,), xs, ys} for every root location scoring >= thresh.

    Latent mode (detect.m:18-22,60-95): when part_boxes (P, 4) is given,
    each part's responses are masked to grid positions whose filter
    window overlaps that part's ground-truth box by >= overlap (IoU),
    optionally with fixed per-part mixtures; only the single best
    detection is returned.

    level_masks (optional): one bool (H, W) array per pyramid level over
    the level's response grid (top-left aligned; e.g. built with
    depth.depth_level_mask). False cells are masked to detect.m's
    finite INF (-1e10) in every part's responses at that level before
    the DP — the host predictor for the device-side plausible-depth
    gating (pipeline.depth_response_masks).
    """
    latent = part_boxes is not None
    cpp = border_mode == "cpp"
    if thresh is None:
        thresh = model.thresh
    feats, box_scales, padx, pady = feature_pyramid(
        im, model, kernels, pad=not cpp
    )
    detections: List[dict] = []

    # per-part octave offsets relative to the root (detect_fast.m:93-105):
    # part_ds[c][p] accumulates anchor(3) down the tree; a part with
    # total offset ds gets its responses from level - ds*interval with a
    # 2^ds grid step and virtual padding.
    part_ds: List[np.ndarray] = []
    for c in range(model.ncomponents):
        P = model.nparts(c)
        ds = np.zeros(P, dtype=np.int64)
        for p in range(1, P):
            d = int(model.defid[c][p][0])
            ds[p] = model.anchors[d][2] + ds[int(model.parentid[c][p])]
        part_ds.append(ds)

    # level-indexed response cache shared across root levels/components
    resp_cache: Dict[Tuple[int, int], np.ndarray] = {}

    # the native library exposes a bank entry (one im2row+SGEMM pass for
    # ALL filters of a level, OpenMP across filters); the hot serving
    # path uses it instead of len(filters) per-filter calls
    has_bank = hasattr(kernels, "fconv_bank") and not cpp

    def resp(lv: int, f: int) -> np.ndarray:
        key = (lv, f)
        if key not in resp_cache:
            if has_bank:
                maps = kernels.fconv_bank(
                    np.ascontiguousarray(feats[lv]), model.filters
                )
                for fi, m in enumerate(maps):
                    resp_cache[(lv, fi)] = m
            elif cpp:
                # C++ 'same'-size engine with one-padded occlusion border
                resp_cache[key] = same_conv_cpp(
                    feats[lv], model.filters[f], kernels
                )
            else:
                resp_cache[key] = kernels.fconv_valid(
                    np.ascontiguousarray(feats[lv]), model.filters[f]
                )
        return resp_cache[key]

    for level in range(len(feats)):
        for c in range(model.ncomponents):
            P = model.nparts(c)
            # all parts' source levels must exist
            part_level = level - part_ds[c] * model.interval
            if part_level.min() < 0:
                continue
            score: Dict[int, np.ndarray] = {}
            for p in range(P):
                lv = int(part_level[p])
                maps = [resp(lv, f) for f in model.filterid[c][p]]
                score[p] = np.stack(maps, axis=-1)  # (Hp, Wp, K)
                if level_masks is not None:
                    lm = level_masks[lv]
                    hh, ww = score[p].shape[:2]
                    score[p] = np.where(
                        lm[:hh, :ww, None], score[p], -1e10
                    )
                if latent:
                    # detect.m:88-99: with fixed mixtures, ONLY the
                    # mixture constraint applies (a reference quirk);
                    # otherwise per-part IoU-overlap masking. The
                    # masking value is a large finite -1e10 (detect.m's
                    # INF), keeping the envelope scan NaN-free.
                    neg = -1e10
                    score[p] = score[p].copy()
                    for k, f in enumerate(model.filterid[c][p]):
                        if fixed_mixtures is not None:
                            if k != fixed_mixtures[p]:
                                score[p][:, :, k] = neg
                            continue
                        fh, fw = model.filters[f].shape[:2]
                        ok = overlap_mask(
                            score[p].shape[:2],
                            (fh, fw),
                            box_scales[int(part_level[p])],
                            padx,
                            pady,
                            part_boxes[p],
                            overlap,
                        )
                        score[p][:, :, k] = np.where(
                            ok, score[p][:, :, k], neg
                        )

            Ix: Dict[int, np.ndarray] = {}
            Iy: Dict[int, np.ndarray] = {}
            Ik: Dict[int, np.ndarray] = {}
            # the native library exposes batched DT + combine entries
            # (K mixtures / L parents per call, no per-call Python
            # marshalling); use them when every mixture shares the grid
            # step — otherwise the generic per-mixture loop
            has_batch = hasattr(kernels, "shift_dt_2d_batch")
            for p in range(P - 1, 0, -1):
                par = int(model.parentid[c][p])
                ny, nx = score[par].shape[:2]
                K = model.nmixtures(c, p)
                L = model.nmixtures(c, par)
                anchs = [model.anchors[int(model.defid[c][p][k])] for k in range(K)]
                steps = [1 << int(a[2]) for a in anchs]
                btab = model.biases[model.biasid[c][p]]  # (L, K)
                if has_batch and len(set(steps)) == 1:
                    step = steps[0]
                    defs_k = np.stack(
                        [model.defs[int(model.defid[c][p][k])] for k in range(K)]
                    )
                    shifts_k = np.array(
                        [
                            [
                                int(a[0]) - (step - 1) * padx,
                                int(a[1]) - (step - 1) * pady,
                            ]
                            for a in anchs
                        ],
                        dtype=np.int64,
                    )
                    scores_k = np.ascontiguousarray(
                        score[p].transpose(2, 0, 1), dtype=np.float64
                    )
                    m0, x0_, y0_ = kernels.shift_dt_2d_batch(
                        scores_k, defs_k, shifts_k, nx, ny, step
                    )
                    msgL, ixL, iyL, ikL = kernels.mixture_combine(
                        m0, x0_, y0_, btab
                    )
                    Ix[p] = ixL.transpose(1, 2, 0).astype(np.int64)
                    Iy[p] = iyL.transpose(1, 2, 0).astype(np.int64)
                    Ik[p] = ikL.transpose(1, 2, 0).astype(np.int64)
                    score[par] = score[par] + msgL.transpose(1, 2, 0)
                    continue
                msg0 = np.zeros((ny, nx, K))
                ix0 = np.zeros((ny, nx, K), dtype=np.int64)
                iy0 = np.zeros((ny, nx, K), dtype=np.int64)
                for k in range(K):
                    d = int(model.defid[c][p][k])
                    anch = model.anchors[d]
                    # per-part octave offset: the child grid is 2^ds x
                    # finer; the message samples it with that step and
                    # virtual padding (detect_fast.m:98-105)
                    step = 1 << int(anch[2])
                    msg0[:, :, k], ix0[:, :, k], iy0[:, :, k] = kernels.shift_dt_2d(
                        score[p][:, :, k],
                        model.defs[d],
                        int(anch[0]) - (step - 1) * padx,
                        int(anch[1]) - (step - 1) * pady,
                        nx,
                        ny,
                        step,
                    )
                msg = np.zeros((ny, nx, L))
                ixp = np.zeros((ny, nx, L), dtype=np.int64)
                iyp = np.zeros((ny, nx, L), dtype=np.int64)
                ikp = np.zeros((ny, nx, L), dtype=np.int64)
                for l in range(L):
                    w = msg0 + btab[l][None, None, :]
                    best = np.argmax(w, axis=-1)
                    msg[:, :, l] = np.take_along_axis(
                        w, best[..., None], axis=-1
                    )[..., 0]
                    ixp[:, :, l] = np.take_along_axis(
                        ix0, best[..., None], axis=-1
                    )[..., 0]
                    iyp[:, :, l] = np.take_along_axis(
                        iy0, best[..., None], axis=-1
                    )[..., 0]
                    ikp[:, :, l] = best
                Ix[p], Iy[p], Ik[p] = ixp, iyp, ikp
                score[par] = score[par] + msg

            root_bias = model.biases[model.biasid[c][0][0]]  # (K_root,)
            rootsc = score[0] + root_bias[None, None, :]
            rscore = rootsc.max(axis=-1)
            rik = np.argmax(rootsc, axis=-1)

            ys, xs = np.nonzero(rscore >= thresh)
            for y0, x0 in zip(ys, xs):
                xv = np.zeros(P, dtype=np.int64)
                yv = np.zeros(P, dtype=np.int64)
                mv = np.zeros(P, dtype=np.int64)
                boxes = np.zeros((P, 4))
                xv[0], yv[0], mv[0] = x0, y0, rik[y0, x0]
                for p in range(P):
                    if p > 0:
                        par = int(model.parentid[c][p])
                        xv[p] = Ix[p][yv[par], xv[par], mv[par]]
                        yv[p] = Iy[p][yv[par], xv[par], mv[par]]
                        mv[p] = Ik[p][yv[par], xv[par], mv[par]]
                    fh, fw = model.filters[model.filterid[c][p][mv[p]]].shape[:2]
                    scale = box_scales[int(part_level[p])]
                    # box origin: MATLAB subtracts the virtual padding;
                    # the C++ demo subtracts one cell (DynamicProgram.cpp:239)
                    off = 1 if cpp else 0
                    x1 = (xv[p] - padx - off) * scale
                    y1 = (yv[p] - pady - off) * scale
                    boxes[p] = [x1, y1, x1 + fw * scale - 1, y1 + fh * scale - 1]
                detections.append(
                    dict(
                        boxes=boxes,
                        score=float(rscore[y0, x0]),
                        component=c,
                        level=level,
                        mixtures=mv.copy(),
                        xs=xv.copy(),
                        ys=yv.copy(),
                    )
                )
    detections.sort(key=lambda d: -d["score"])
    if latent:
        return detections[:1]
    return detections
