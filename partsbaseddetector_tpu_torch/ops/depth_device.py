"""Depth-consistency filtering of candidates on the device.

Port of `partsbaseddetector_tpu/ops/depth_device.py`. The candidate
depth filter (src/SearchSpacePruning.cpp:73-95) keeps a candidate when
every connected parent/child pair of its parts has median box depths
that differ by at most ||anchor|| * zfactor. The part boxes are already
on the device after backtracking, so the medians and the keep decision
run there and the host applies a (max_det,) bool mask.

Medians follow include/Math.hpp:62-72: the element at n/2 of the sorted
finite values of the clipped box (the upper middle, no averaging); an
empty or all-invalid box gives 0.0, which passes the filter. Boxes
whose clipped sides fit `cap` (48 px) are exact: every pixel is
gathered once. Larger boxes gather a strided cap x cap grid, an
approximation; the host path in depth.py stays exact.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def box_depth_medians(
    depth: torch.Tensor, boxes: torch.Tensor, cap: int = 48
) -> torch.Tensor:
    """Median depth per box. depth (H, W) float; boxes (B, 4)
    [x1, y1, x2, y2] inclusive image coordinates (float, as backtrack
    emits them). Returns (B,) medians in depth's dtype."""
    h, w = depth.shape
    dev = depth.device
    # depth.py::_clip_box: x1 = int(max(b0, 0)), x2 = int(min(b2 + 1, w))
    # exclusive; floor equals int() truncation on the non-negative values
    # that matter (negatives only occur for empty boxes, which give 0)
    x1 = torch.floor(boxes[:, 0].clamp_min(0)).long()
    y1 = torch.floor(boxes[:, 1].clamp_min(0)).long()
    x2 = torch.floor((boxes[:, 2] + 1).clamp_max(w)).long()
    y2 = torch.floor((boxes[:, 3] + 1).clamp_max(h)).long()
    bw = x2 - x1
    bh = y2 - y1

    i = torch.arange(cap, device=dev)
    # unit stride (exact) when the side fits the budget, else side/cap:
    # floor(i * max(side, cap) / cap) is i for side <= cap
    sx = bw.clamp_min(cap)[:, None]
    sy = bh.clamp_min(cap)[:, None]
    ix = (x1[:, None] + torch.div(i[None, :] * sx, cap, rounding_mode="floor")
          ).clamp(0, w - 1)
    iy = (y1[:, None] + torch.div(i[None, :] * sy, cap, rounding_mode="floor")
          ).clamp(0, h - 1)
    vx = i[None, :] < bw.clamp_max(cap)[:, None]  # (B, cap)
    vy = i[None, :] < bh.clamp_max(cap)[:, None]

    vals = depth[iy[:, :, None], ix[:, None, :]]  # (B, cap, cap)
    valid = vy[:, :, None] & vx[:, None, :] & torch.isfinite(vals)
    vals = torch.where(valid, vals, torch.full((), torch.inf, dtype=vals.dtype,
                                               device=dev))
    vals = vals.reshape(vals.shape[0], -1)
    n = valid.reshape(valid.shape[0], -1).sum(dim=1)
    ordered = torch.sort(vals, dim=1).values
    med = torch.gather(ordered, 1, (n // 2).clamp_max(cap * cap - 1)[:, None])[:, 0]
    return torch.where(n > 0, med, torch.zeros_like(med))


def component_tables(packed) -> Tuple[np.ndarray, np.ndarray]:
    """Per-component (parentid, anchor norm) tables padded to (C, P_max).
    Padded part slots get parent 0 and an +inf norm (their boxes repeat
    the root box, so they cannot trip the threshold); the root's norm is
    +inf too (it has no parent edge)."""
    c_count = len(packed.components)
    p_max = packed.max_nparts
    par = np.zeros((c_count, p_max), dtype=np.int32)
    norms = np.full((c_count, p_max), np.inf, dtype=np.float32)
    for c, comp in enumerate(packed.components):
        p = comp.nparts
        par[c, :p] = np.asarray(comp.parentid[:p], dtype=np.int32)
        a = np.asarray(comp.anchor[1:p, 0, :2], dtype=np.float64)
        norms[c, 1:p] = np.linalg.norm(a, axis=1)
    return par, norms


def depth_keep_mask(
    depth: torch.Tensor,
    boxes: torch.Tensor,  # (K, P, 4)
    comps: torch.Tensor,  # (K,) int
    parent_tbl: torch.Tensor,  # (C, P) int, on depth's device
    norm_tbl: torch.Tensor,  # (C, P) float, on depth's device
    zfactor: float = 0.5,
    cap: int = 48,
) -> torch.Tensor:
    """(K,) bool: True where the candidate passes the depth-consistency
    filter (reject when a child/parent pair with both medians > 0
    differs by more than ||anchor|| * zfactor)."""
    k, p, _ = boxes.shape
    meds = box_depth_medians(depth, boxes.reshape(k * p, 4), cap).reshape(k, p)
    comps = comps.long()
    par = parent_tbl[comps].long()  # (K, P)
    norms = norm_tbl[comps].to(meds.dtype)
    pmed = torch.gather(meds, 1, par)
    bad = (meds > 0) & (pmed > 0) & ((meds - pmed).abs() > norms * zfactor)
    bad[:, 0] = False  # the root carries no edge
    return ~bad.any(dim=1)
