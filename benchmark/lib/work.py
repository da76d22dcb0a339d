"""The work a frame needs, counted from the configuration's shapes, and
the card's published peaks: the yardstick of the roofline shares and of
step_mfu. Nothing here reads the program.

Peaks are those of one NVIDIA H100 SXM at its 700 W power limit
(NVIDIA's data sheet, dense rates): HBM3 3.35 TB/s, FP32 67 TFLOP/s off
the tensor cores, TF32 495 TFLOP/s on them. The f32 profile allows no
single-pass TF32: an f32 product costs three TF32 products (3xTF32), so
its rate is 495 / 3 = 165 TFLOP/s. A card set below 700 W runs slower;
the run reports the card's power limit beside its numbers.

Pyramid levels follow featpyramid.m's sizes (C rounding), as
pbd_tree.pyramid builds them; a level's responses cover its padded
features less the filter plus one. The work is that of the levels at
their own sizes, whatever stacks an implementation pads them into:
`conv_work_padded` counts the bucket stacks that the program's batched
correlation reads (`interval / buckets_per_octave` consecutive levels
padded to the largest of them plus the filter less one), a figure of
the implementation that no metric reads.

A model's filters are its pool (lib/spec.py::trees), correlated once
however many parts of however many components name each; its DT
children are every component's parts but the root, each with its K
mixtures.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from . import spec

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
F32_PROFILE_FLOPS = TF32_FLOPS / 3.0
POWER_LIMIT_W = 700.0
# operations of one output of the generalized DT's lower-envelope scan:
# ~10 as each live source enters and leaves the envelope, ~5 as each
# output reads it (shiftdt.cc)
DT_OPS_PER_CELL = 15.0


def cround(x: float) -> int:
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


def levels(cfg: dict) -> List[Tuple[int, int]]:
    """Padded feature (height, width) of every pyramid level."""
    h, w = cfg["frame_h"], cfg["frame_w"]
    interval, sbin = cfg["interval"], cfg["sbin"]
    sc = 2.0 ** (1.0 / interval)
    n = 1 + int(math.floor(math.log(min(h, w) / (5.0 * sbin)) / math.log(sc)))
    sizes = [None] * n
    for i in range(min(interval, n)):
        f = 1.0 / sc**i
        sizes[i] = (cround(h * f), cround(w * f))
        j = i + interval
        while j < n:
            ph, pw = sizes[j - interval]
            sizes[j] = (cround(ph * 0.5), cround(pw * 0.5))
            j += interval
    pady, padx = cfg["filter_h"] - 2, cfg["filter_w"] - 2
    out = []
    for ih, iw in sizes:
        fh = max(cround(ih / sbin) - 2, 0)
        fw = max(cround(iw / sbin) - 2, 0)
        out.append((fh + 2 * (pady + 1), fw + 2 * (padx + 1)))
    return out


def response_cells(cfg: dict) -> List[int]:
    """Response cells of every level (one filter's valid correlation)."""
    return [(h - cfg["filter_h"] + 1) * (w - cfg["filter_w"] + 1) for h, w in levels(cfg)]


def n_filters(cfg: dict) -> int:
    """Filters of the pool."""
    return spec.trees(cfg)[0]


def dt_children(cfg: dict) -> int:
    """Distance transforms a level: sum over components of (P_c - 1) K."""
    return sum(len(t["parents"]) - 1 for t in spec.trees(cfg)[1]) * cfg["mixtures"]


def filter_macs(cfg: dict) -> int:
    return cfg["filter_h"] * cfg["filter_w"] * cfg["hog_channels"]


def conv_work(cfg: dict, images: int = 1) -> Tuple[float, float]:
    """(FLOPs, bytes) of the correlation of every filter over every
    pyramid level at its own size for `images` frames: 2 per
    multiply-add, each level's features read once and its responses
    written once (f32), the filter bank read once."""
    nf, c = n_filters(cfg), cfg["hog_channels"]
    cells = response_cells(cfg)
    flops = 2.0 * sum(cells) * filter_macs(cfg) * nf
    nbytes = 4.0 * sum(h * w * c for h, w in levels(cfg)) + 4.0 * sum(cells) * nf
    return images * flops, images * nbytes + 4.0 * nf * filter_macs(cfg)


def conv_work_padded(cfg: dict, images: int = 1) -> Tuple[float, float]:
    """conv_work over the bucket stacks that the program pads the levels
    into (its `buckets_per_octave`): the implementation's figure."""
    lv = levels(cfg)
    per = cfg["interval"] // cfg["buckets_per_octave"]
    nf, c = n_filters(cfg), cfg["hog_channels"]
    fh, fw = cfg["filter_h"], cfg["filter_w"]
    flops = nbytes = 0.0
    for start in range(0, len(lv), per):
        group = lv[start : start + per]
        bh = max(h for h, _ in group) + fh - 1
        bw = max(w for _, w in group) + fw - 1
        rh, rw = bh - fh + 1, bw - fw + 1
        flops += 2.0 * len(group) * rh * rw * filter_macs(cfg) * nf
        nbytes += 4.0 * len(group) * (bh * bw * c + rh * rw * nf)
    return images * flops, images * nbytes + 4.0 * nf * filter_macs(cfg)


def conv_bound_s(cfg: dict, images: int = 1, work=conv_work) -> float:
    """Least seconds for the correlation's work: the larger of its bytes
    at the HBM rate and its products in 3xTF32 at the TF32 peak."""
    flops, nbytes = work(cfg, images)
    return max(nbytes / HBM_BYTES_PER_S, 3.0 * flops / TF32_FLOPS)


def dt_bytes(cfg: dict, images: int = 1) -> float:
    """Bytes of every DT pass of a detect: for each level and each child
    part's mixture (dt_children), the y pass reads its source and writes values and
    pointers (12 bytes a cell), the x pass reads those values and
    pointers and writes its own (16 bytes a cell)."""
    return images * 28.0 * dt_children(cfg) * sum(response_cells(cfg))


def dt_bound_s(cfg: dict, images: int = 1) -> float:
    return dt_bytes(cfg, images) / HBM_BYTES_PER_S


def model_flops(cfg: dict) -> float:
    """FLOPs of one frame by the model's own arithmetic: the exact
    pyramid's correlations (2 per multiply-add, every level at its own
    size, no bucket padding) and the DT passes' envelope scans (y and x,
    DT_OPS_PER_CELL an output cell). The HOG is not counted."""
    cells = sum(response_cells(cfg))
    conv = 2.0 * cells * filter_macs(cfg) * n_filters(cfg)
    return conv + 2.0 * DT_OPS_PER_CELL * cells * dt_children(cfg)
