"""Accuracy evaluation: PCK, APK, VOC average precision.

First-class Python re-expression of the reference's MATLAB evaluation
harness (matlab/evaluation/eval_pck.m, eval_apk.m, VOCap.m) — the C++
side's Metrics.hpp is a broken stub (SURVEY.md §2.1).

Conventions: keypoints are (N, P, 2) arrays of (x, y); detections carry
per-keypoint confidence for APK. Reference scales the PCK threshold by
max(height, width) of the ground-truth extent per example.

A copy of `partsbaseddetector_tpu/eval/metrics.py`, so that the port
never imports the JAX package. `test_model` and `test_model_gtbox` take
any detector with `detect(im)`: the port's PartsBasedDetector (card or
CPU) or its CPUPartsBasedDetector.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def boxes_to_keypoints(boxes: np.ndarray) -> np.ndarray:
    """Part boxes (..., P, 4) -> centers (..., P, 2) (x, y)."""
    x = 0.5 * (boxes[..., 0] + boxes[..., 2])
    y = 0.5 * (boxes[..., 1] + boxes[..., 3])
    return np.stack([x, y], axis=-1)


def eval_pck(
    pred: np.ndarray, gt: np.ndarray, thresh: float = 0.1
) -> np.ndarray:
    """Percentage of Correct Keypoints per part.

    pred, gt: (N, P, 2). A keypoint is correct when its error is within
    thresh * max(gt_height, gt_width) of that example's ground-truth
    extent (eval_pck.m:1-13). Returns (P,) accuracies.
    """
    assert pred.shape == gt.shape
    ext = np.maximum(
        gt[..., 0].max(1) - gt[..., 0].min(1),
        gt[..., 1].max(1) - gt[..., 1].min(1),
    )  # (N,)
    err = np.linalg.norm(pred - gt, axis=-1)  # (N, P)
    ok = err <= thresh * ext[:, None]
    return ok.mean(axis=0)


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC-style AP: area under the monotone precision envelope with
    endpoint padding (VOCap.m:1-10)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def eval_apk(
    preds: Sequence[np.ndarray],
    scores: Sequence[np.ndarray],
    gts: Sequence[np.ndarray],
    thresh: float = 0.1,
) -> np.ndarray:
    """Average Precision of Keypoints per part (eval_apk.m:1-46).

    preds[i]: (D_i, P, 2) detected keypoints for image i;
    scores[i]: (D_i,) detection confidences;
    gts[i]: (G_i, P, 2) ground-truth keypoint sets.
    Greedy highest-score-first assignment; a detection's keypoint is a
    true positive if within thresh * gt extent of an unmatched GT.
    Returns (P,) AP values.
    """
    nparts = gts[0].shape[1] if len(gts) else 0
    aps = np.zeros(nparts)
    for p in range(nparts):
        rows: List[Tuple[float, int, int]] = []  # (score, img, det)
        npos = 0
        for i, g in enumerate(gts):
            npos += g.shape[0]
            for d in range(preds[i].shape[0]):
                rows.append((float(scores[i][d]), i, d))
        rows.sort(key=lambda r: -r[0])
        tp = np.zeros(len(rows))
        fp = np.zeros(len(rows))
        used = {i: np.zeros(g.shape[0], dtype=bool) for i, g in enumerate(gts)}
        for r, (_, i, d) in enumerate(rows):
            g = gts[i]
            if g.shape[0] == 0:
                fp[r] = 1
                continue
            ext = np.maximum(
                g[:, :, 0].max(1) - g[:, :, 0].min(1),
                g[:, :, 1].max(1) - g[:, :, 1].min(1),
            )  # (G,)
            err = np.linalg.norm(preds[i][d, p] - g[:, p], axis=-1)
            ok = (err <= thresh * ext) & ~used[i]
            j = int(np.argmin(np.where(ok, err, np.inf)))
            if ok.any() and ok[j]:
                tp[r] = 1
                used[i][j] = True
            else:
                fp[r] = 1
        if npos == 0:
            aps[p] = 0.0
            continue
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / npos
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        aps[p] = voc_ap(recall, precision)
    return aps


def test_model(
    detector,
    images: Sequence[np.ndarray],
    gts: Sequence[np.ndarray],
    thresh: float = 0.1,
    nms_overlap: float = 0.3,
):
    """End-to-end accuracy harness (testmodel.m analog): detect on every
    image, part-NMS, take the best candidate, report PCK."""
    from ..ops.nms import part_nms

    preds = []
    for im in images:
        cands = detector.detect(im)
        if not cands:
            preds.append(np.full_like(gts[0][0], np.nan))
            continue
        boxes = np.stack([c.parts for c in cands])
        sc = np.array([c.score for c in cands])
        keep = part_nms(boxes, sc, nms_overlap)
        best = cands[int(keep[0])] if len(keep) else cands[0]
        preds.append(boxes_to_keypoints(best.parts))
    return eval_pck(np.stack(preds), np.stack([g[0] for g in gts]), thresh)


def best_overlap(boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """Mean per-part IoU of each detection against ground-truth part
    boxes (bestoverlap.m): boxes (D, P, 4), gt_boxes (P, 4) -> (D,)."""
    x1 = np.maximum(boxes[..., 0], gt_boxes[None, :, 0])
    y1 = np.maximum(boxes[..., 1], gt_boxes[None, :, 1])
    x2 = np.minimum(boxes[..., 2], gt_boxes[None, :, 2])
    y2 = np.minimum(boxes[..., 3], gt_boxes[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    a1 = (boxes[..., 2] - boxes[..., 0] + 1) * (boxes[..., 3] - boxes[..., 1] + 1)
    a2 = (gt_boxes[:, 2] - gt_boxes[:, 0] + 1) * (gt_boxes[:, 3] - gt_boxes[:, 1] + 1)
    iou = inter / (a1 + a2[None] - inter)
    return iou.mean(axis=-1)


def test_model_gtbox(
    detector, images, gt_part_boxes, overlap: float = 0.5
):
    """Constrained evaluation (testmodel_gtbox.m): latent-style best
    detection per image given GT part boxes, reporting mean best
    overlap. Uses the reference pipeline's latent masking."""
    overlaps = []
    for im, gt in zip(images, gt_part_boxes):
        # run detect and rank candidates by overlap with the GT
        cands = detector.detect(im)
        if not cands:
            overlaps.append(0.0)
            continue
        boxes = np.stack([c.parts for c in cands])
        ov = best_overlap(boxes, np.asarray(gt))
        overlaps.append(float(ov.max()))
    return np.asarray(overlaps)
