"""The comparison that decides `correct`: what the timed path returned,
held against the plain reference of the same frame.

A detector's answer to a frame is a list of candidates, best first,
each with a root score, one box per part, the component and a mixture
per part. Each candidate is turned back into its placement in its own
component's tree: the root's level, whose box scale its root box's
width over its root filter's own width gives; each part's level, that
less interval for each octave the part lies below the root; and every
part's cell from its box's corner on its own level's scale, its box
from its own filter's size. A candidate whose component the model
lacks, or whose parts are not that component's count, makes every
number inf. Four numbers are then taken, each the largest over
every compared answer:

    score_gap   |claimed score - the reference's best score of the
                candidate's component at that root cell|: a wrong score,
                a root on the wrong cell or in the wrong component
    place_gap   |the reference's best score at the root cell - the
                reference's score of the claimed parts and mixtures|: a
                part on the wrong cell or with the wrong mixture (a tie
                between two placements reads 0, whichever is returned)
    box_gap_px  |claimed box - the box of the placement it decodes to|,
                in pixels: a box off the cell grid
    list_gap    the claimed scores, in order, against the reference's
                scores of every (component, root cell) at or above the
                threshold, best first, up to the candidate budget; a list
                shorter than the other counts the threshold in its place:
                a candidate left out, added or out of order

Scores are the model's own units. The limits of each configuration are
in its file, with the readings they were set from in PERF.md.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import numpy as np
import torch


def answer_readings(cands, det, model, cfg: dict, ref) -> Dict[str, float]:
    """The four numbers for one answer (a candidate list) against the
    reference `det` of its frame; `ref` is the reference module."""
    thresh = float(cfg["thresh"])
    budget = int(cfg["max_detections"])
    want = det.scores[:budget].cpu().numpy()
    got = np.array([c.score for c in cands], dtype=np.float64)
    n = max(len(want), len(got))
    pad = lambda a: np.concatenate([a, np.full(n - len(a), thresh)])
    out = {"list_gap": float(np.abs(pad(got) - pad(want)).max()) if n else 0.0,
           "score_gap": 0.0, "place_gap": 0.0, "box_gap_px": 0.0}
    trees = model.trees
    for c in cands:
        nparts = len(trees[c.component].parent) if 0 <= c.component < len(trees) else -1
        if len(c.parts) != nparts or c.mixtures is None or len(c.mixtures) != nparts:
            return {k: math.inf for k in out}
    dev = det.root.device
    pady, padx = model.pad
    sizes = model.sizes.cpu().numpy()
    interval = int(cfg["interval"])
    scales = np.asarray(det.scales, dtype=np.float64)
    t = lambda a: torch.as_tensor(a, device=dev)
    gap = lambda a, b: float(np.nan_to_num(np.abs(a - b), nan=math.inf).max())
    comps = np.array([c.component for c in cands])
    for comp in np.unique(comps):
        rows = np.flatnonzero(comps == comp)
        boxes = np.stack([cands[i].parts for i in rows]).astype(np.float64)  # (N, P, 4)
        mix = np.stack([cands[i].mixtures for i in rows]).astype(np.int64)
        tree = trees[comp]
        k = tree.defs.shape[1]
        nparts = len(tree.parent)
        fid = tree.filterid.cpu().numpy()[np.arange(nparts)[None, :], mix.clip(0, k - 1)]
        fh, fw = sizes[fid, 0], sizes[fid, 1]  # (N, P) each part's own filter
        width = boxes[:, 0, 2] - boxes[:, 0, 0] + 1.0
        est = np.where(width > 0, width / fw[:, 0], np.nan)
        level = np.abs(np.log(scales)[None, :] - np.log(est)[:, None]).argmin(1)
        level = np.where(np.isfinite(est), level, 0)
        # each part's level (clipped only to index: a root level with no
        # level an octave below has no root in the reference, -inf there)
        octaves = np.array(tree.octaves(), dtype=np.int64)
        levels = (level[:, None] - octaves[None, :] * interval).clip(0)
        sc = scales[levels]
        xs = np.rint(boxes[..., 0] / sc).astype(np.int64) + padx
        ys = np.rint(boxes[..., 1] / sc).astype(np.int64) + pady
        x1 = (xs - padx) * sc
        y1 = (ys - pady) * sc
        rebuilt = np.stack([x1, y1, x1 + fw * sc - 1, y1 + fh * sc - 1], -1)
        box_gap = gap(boxes, rebuilt) if np.isfinite(est).all() else math.inf
        bad_mix = ((mix < 0) | (mix >= k)).any(1)
        best = ref.root_score_at(det, int(comp), t(level), t(xs[:, 0]),
                                 t(ys[:, 0])).cpu().numpy()
        placed = ref.placement_score(det, model, int(comp), t(levels), t(xs), t(ys),
                                     t(mix.clip(0, k - 1))).cpu().numpy()
        placed[bad_mix] = -math.inf
        out.update(score_gap=max(out["score_gap"], gap(got[rows], best)),
                   place_gap=max(out["place_gap"], gap(best, placed)),
                   box_gap_px=max(out["box_gap_px"], box_gap))
    return out


def answer_key(cands) -> bytes:
    """A digest of everything an answer claims: answers with the same
    key read the same numbers."""
    h = hashlib.sha256()
    for c in cands:
        for a in (c.parts, c.confidence, c.mixtures, np.int64(c.component)):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over the compared answers (a number
    that an answer lacks reads inf)."""
    keys = dict.fromkeys(k for r in readings for k in r)
    return {k: max(r.get(k, math.inf) for r in readings) for k in keys}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit read, and within its limit."""
    return bool(numbers) and set(numbers) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
