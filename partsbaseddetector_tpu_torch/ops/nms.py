"""Non-maxima suppression variants.

Port of `partsbaseddetector_tpu/ops/nms.py`. Three capabilities from the
reference:
  1. part-aware greedy box NMS (matlab/detection/nms.m): per-part IoA
     overlap against the kept set, including the union covering box,
     capped at 1000 candidates: `part_nms` (a NumPy copy) and
     `part_nms_device` (torch, on the detector's device; the detector's
     `nms_overlap` option);
  2. pixel-level block local-maxima NMS over a score map
     (src/nms.cpp:84-129, Neubeck & Van Gool; exported but unused by the
     reference pipeline): `pixel_nms` (a NumPy copy) and
     `pixel_nms_device` (torch max pooling);
  3. greedy paint NMS lives on types.Candidate.non_maxima_suppression
     (include/Candidate.hpp:277-304), the variant the C++ apps call.

Candidate counts are static on the device (masks, not shrinking lists).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Part-aware greedy box NMS (detection/nms.m)
# ---------------------------------------------------------------------------


def part_nms(
    boxes: np.ndarray,
    scores: np.ndarray,
    overlap: float = 0.5,
    max_candidates: int = 1000,
) -> np.ndarray:
    """Greedy part-aware NMS. boxes (N, P, 4), scores (N,).

    A candidate is suppressed if, for *any* part (or the union covering
    box), its intersection with a kept candidate's same part exceeds
    `overlap` of the kept part's area (intersection-over-kept-area, as
    nms.m:58-69 computes). Returns indices of kept candidates in
    descending score order.
    """
    n = boxes.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(-scores, kind="stable")
    if n > max_candidates:
        order = order[:max_candidates]
    b = boxes[order].astype(np.float64)
    # append the union covering box as an extra "part" (nms.m:37-48)
    union = np.concatenate(
        [
            b[:, :, 0].min(1, keepdims=True),
            b[:, :, 1].min(1, keepdims=True),
            b[:, :, 2].max(1, keepdims=True),
            b[:, :, 3].max(1, keepdims=True),
        ],
        axis=1,
    )[:, None, :]
    b = np.concatenate([b, union], axis=1)  # (N, P+1, 4)
    area = (b[:, :, 2] - b[:, :, 0] + 1) * (b[:, :, 3] - b[:, :, 1] + 1)

    keep: List[int] = []
    alive = np.ones(len(order), dtype=bool)
    for i in range(len(order)):
        if not alive[i]:
            continue
        keep.append(order[i])
        xx1 = np.maximum(b[i, :, 0], b[:, :, 0])
        yy1 = np.maximum(b[i, :, 1], b[:, :, 1])
        xx2 = np.minimum(b[i, :, 2], b[:, :, 2])
        yy2 = np.minimum(b[i, :, 3], b[:, :, 3])
        w = np.clip(xx2 - xx1 + 1, 0, None)
        h = np.clip(yy2 - yy1 + 1, 0, None)
        o = (w * h) / area[i][None, :]  # IoA vs the *kept* candidate
        alive &= o.max(axis=1) <= overlap
        alive[i] = False
    return np.asarray(keep, dtype=np.int64)


def part_nms_device(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    overlap: float = 0.5,
) -> torch.Tensor:
    """Part-aware NMS over a static candidate budget, on the boxes'
    device.

    boxes ([B,] N, P, 4) pre-sorted by descending score, valid ([B,] N)
    bool, an optional leading image axis B. Returns the keep mask
    ([B,] N). All geometry is one batched computation of the (N, N)
    suppression matrix per image; the greedy decision chain is a true
    data dependence, so it runs as a loop over N, each step batched
    over the images (a batch of 8 costs N steps, not 8N). `scores` is
    not read: the order is the input order, as in the JAX package.
    """
    single = boxes.dim() == 3
    if single:
        boxes, valid = boxes[None], valid[None]
    n = boxes.shape[1]
    union = torch.stack(
        [
            boxes[..., 0].amin(-1),
            boxes[..., 1].amin(-1),
            boxes[..., 2].amax(-1),
            boxes[..., 3].amax(-1),
        ],
        dim=-1,
    )[:, :, None, :]
    b = torch.cat([boxes, union], dim=2)  # (B, N, P+1, 4)
    area = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)

    # pairwise IoA[b, i, j, part]: intersection(i, j) / area(i)
    xx1 = torch.maximum(b[:, :, None, :, 0], b[:, None, :, :, 0])
    yy1 = torch.maximum(b[:, :, None, :, 1], b[:, None, :, :, 1])
    xx2 = torch.minimum(b[:, :, None, :, 2], b[:, None, :, :, 2])
    yy2 = torch.minimum(b[:, :, None, :, 3], b[:, None, :, :, 3])
    w = (xx2 - xx1 + 1).clamp(min=0)
    h = (yy2 - yy1 + 1).clamp(min=0)
    ioa = (w * h) / area[:, :, None, :]
    suppresses = ioa.amax(-1) > overlap  # (B, kept_i, candidate_j)

    # candidate i survives if valid and no kept earlier candidate
    # suppresses it
    kept = torch.zeros_like(valid)
    for i in range(n):
        killed = (kept & suppresses[:, :, i]).any(dim=1)
        kept[:, i] = valid[:, i] & ~killed
    return kept[0] if single else kept


# ---------------------------------------------------------------------------
# Pixel-level block local-maxima NMS (src/nms.cpp)
# ---------------------------------------------------------------------------


def pixel_nms(src: np.ndarray, sz: int, mask: np.ndarray | None = None) -> np.ndarray:
    """255-mask of strict local maxima of (2sz+1)^2 windows.

    Block-partition the map into (sz+1)-sized blocks, take each block's
    maximum, then verify it against its full (2sz+1)^2 neighborhood —
    the Neubeck & Van Gool ICPR'06 scheme the reference vendors. An
    optional mask restricts eligible maxima.
    """
    h, w = src.shape
    out = np.zeros((h, w), dtype=np.uint8)
    step = sz + 1
    neg = -np.inf
    s = src.astype(np.float64)
    if mask is not None:
        s = np.where(mask != 0, s, neg)
    for by in range(0, h, step):
        for bx in range(0, w, step):
            blk = s[by : by + step, bx : bx + step]
            if not np.isfinite(blk).any():
                continue
            iy, ix = np.unravel_index(np.argmax(blk), blk.shape)
            cy, cx = by + iy, bx + ix
            v = s[cy, cx]
            y1, y2 = max(cy - sz, 0), min(cy + sz + 1, h)
            x1, x2 = max(cx - sz, 0), min(cx + sz + 1, w)
            neigh = s[y1:y2, x1:x2].copy()
            neigh[cy - y1, cx - x1] = neg
            if v > neigh.max():
                out[cy, cx] = 255
    return out


def pixel_nms_device(src: torch.Tensor, sz: int) -> torch.Tensor:
    """Local-maxima mask of an (H, W) map on its device: src[y, x] is a
    maximum iff it strictly exceeds every other value in its
    (2sz+1)^2 window. A max pool (padding counts as -inf) gives the
    window maximum, a sum pool of the equality mask (padding counts as
    0) how often it occurs; a maximum occurs exactly once."""
    k = 2 * sz + 1
    x = src[None, None].to(torch.float32)
    neigh_max = F.max_pool2d(x, k, stride=1, padding=sz)
    eq = x == neigh_max
    count = F.avg_pool2d(
        eq.to(torch.float32), k, stride=1, padding=sz,
        count_include_pad=True, divisor_override=1,
    )
    return (eq & (count == 1))[0, 0]
