"""NumPy pieces of the JAX package's reference pipeline that the port
needs.

A framework-free copy of `partsbaseddetector_tpu/ops/reference_pipeline.py::
overlap_mask` (detect.m testoverlap), used by `pipeline.build_root_masks`
for the latent-positive root constraint of training.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
