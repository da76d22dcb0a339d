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
pbd_tree.pyramid builds them in the configuration's form (lib/spec.py's
`pyramid`: the "dpm" form puts an octave of HOG at sbin / 2 on the
first octave's images before the "pose" form's levels, and its later
octaves' area resizes by 0.5 round as the reduces do), padded by the
configuration's maxsize; a filter's responses on a level cover the
padded features less the filter plus one. The work is that of the
levels and the filters at their own sizes, whatever stacks an
implementation pads them into:
`conv_work_padded` counts the bucket stacks that the program's batched
correlation reads (`interval / buckets_per_octave` consecutive levels
padded to the largest of them plus the bank less one, every filter at
the bank's size), a figure of the implementation that no metric reads.

A model's filters are its pool (lib/spec.py::trees), correlated once a
level at its own size however many parts of however many components
name each. Its DT children are every component's parts but the root,
each with its K mixtures, at every root level that carries a root of
the component (those with a level d * interval below them, for the
component's deepest octave d): a child's map has its own filter's
response grid on its own level, and its DT writes on its parent's grid,
that of the parent's smallest mixture on the parent's level. Every
count is a whole number below 2^53, so each figure is exact in a float,
whatever the order of the sums: a one-size configuration with every
part on its parent's level reads the figures of the one-size arithmetic
to the bit.
"""

from __future__ import annotations

import collections
import math
from typing import List, Optional, Tuple

from . import spec

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
F32_PROFILE_FLOPS = TF32_FLOPS / 3.0
POWER_LIMIT_W = 700.0
# operations of the generalized DT's lower-envelope scan (shiftdt.cc):
# ~10 as each live source enters and leaves the envelope, ~5 as each
# output reads it
DT_OPS_PER_SOURCE = 10
DT_OPS_PER_OUTPUT = 5


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
    bins = [sbin] * len(sizes)
    if spec.pyramid(cfg) == "dpm":
        half = [(cround(h * (1.0 / sc**i)), cround(w * (1.0 / sc**i)))
                for i in range(min(interval, n + interval))]
        sizes, bins = half + sizes, [sbin // 2] * len(half) + bins
    my, mx = spec.maxsize(cfg)
    pady, padx = max(my - 2, 0), max(mx - 2, 0)
    out = []
    for (ih, iw), cell in zip(sizes, bins):
        fh = max(cround(ih / cell) - 2, 0)
        fw = max(cround(iw / cell) - 2, 0)
        out.append((fh + 2 * (pady + 1), fw + 2 * (padx + 1)))
    return out


def grids(cfg: dict, size: Tuple[int, int]) -> List[Tuple[int, int]]:
    """(rows, columns) of one filter's responses on every level."""
    fh, fw = size
    return [(h - fh + 1, w - fw + 1) for h, w in levels(cfg)]


def response_cells(cfg: dict, size: Optional[Tuple[int, int]] = None) -> List[int]:
    """Response cells of every level of one filter of `size` (default:
    the padding's, every filter's in a one-size configuration)."""
    return [h * w for h, w in grids(cfg, size or spec.maxsize(cfg))]


def n_filters(cfg: dict) -> int:
    """Filters of the pool."""
    return spec.trees(cfg)[0]


def dt_children(cfg: dict) -> int:
    """Distance transforms a root level: sum over components of (P_c - 1) K."""
    return sum(len(t["parents"]) - 1 for t in spec.trees(cfg)[1]) * cfg["mixtures"]


def filter_macs(cfg: dict, size: Optional[Tuple[int, int]] = None) -> int:
    fh, fw = size or spec.maxsize(cfg)
    return fh * fw * cfg["hog_channels"]


def _conv_counts(cfg: dict) -> Tuple[int, int, int]:
    """(multiply-adds, response cells, bank values) of one frame's
    correlation: each pool filter once a level at its own size."""
    macs = cells = bank = 0
    for size, n in collections.Counter(spec.filter_sizes(cfg)).items():
        c = sum(response_cells(cfg, size))
        macs += n * c * filter_macs(cfg, size)
        cells += n * c
        bank += n * filter_macs(cfg, size)
    return macs, cells, bank


def conv_work(cfg: dict, images: int = 1) -> Tuple[float, float]:
    """(FLOPs, bytes) of the correlation of every filter over every
    pyramid level at its own size for `images` frames: 2 per
    multiply-add, each level's features read once and each filter's
    responses written once (f32), the filter bank read once."""
    macs, cells, bank = _conv_counts(cfg)
    feats = sum(h * w * cfg["hog_channels"] for h, w in levels(cfg))
    return images * float(2 * macs), images * float(4 * (feats + cells)) + float(4 * bank)


def conv_work_padded(cfg: dict, images: int = 1) -> Tuple[float, float]:
    """conv_work over the bucket stacks that the program pads the levels
    into (its `buckets_per_octave`), every filter at the bank's size:
    the implementation's figure."""
    lv = levels(cfg)
    per = cfg["interval"] // cfg["buckets_per_octave"]
    nf, c = n_filters(cfg), cfg["hog_channels"]
    sizes = spec.filter_sizes(cfg)
    fh, fw = max(h for h, _ in sizes), max(w for _, w in sizes)
    macs = filter_macs(cfg, (fh, fw))
    flops = nbytes = 0.0
    for start in range(0, len(lv), per):
        group = lv[start : start + per]
        bh = max(h for h, _ in group) + fh - 1
        bw = max(w for _, w in group) + fw - 1
        rh, rw = bh - fh + 1, bw - fw + 1
        flops += 2.0 * len(group) * rh * rw * macs * nf
        nbytes += 4.0 * len(group) * (bh * bw * c + rh * rw * nf)
    return images * flops, images * nbytes + 4.0 * nf * macs


def conv_bound_s(cfg: dict, images: int = 1, work=conv_work) -> float:
    """Least seconds for the correlation's work: the larger of its bytes
    at the HBM rate and its products in 3xTF32 at the TF32 peak."""
    flops, nbytes = work(cfg, images)
    return max(nbytes / HBM_BYTES_PER_S, 3.0 * flops / TF32_FLOPS)


def dt_maps(cfg: dict) -> Tuple[int, int, int]:
    """Cells summed over every DT child map of one frame: (sources, the
    y pass's outputs, the x pass's outputs). The y pass reads the
    child's grid and writes the parent's rows of its columns; the x
    pass writes the parent's grid."""
    _, trees = spec.trees(cfg)
    sizes = spec.filter_sizes(cfg)
    interval = cfg["interval"]
    memo = {}

    def grid(size, level):
        if size not in memo:
            memo[size] = grids(cfg, size)
        return memo[size][level]

    n = len(levels(cfg))
    src = mid = out = 0
    for t in trees:
        octave = [0] * len(t["parents"])
        for p in range(1, len(octave)):
            octave[p] = octave[t["parents"][p]] + t["ds"][p]
        # a part's map grid on its level: its smallest mixture's
        part = [(min(sizes[f][0] for f in row), min(sizes[f][1] for f in row))
                for row in t["filters"]]
        for level in range(max(octave) * interval, n):
            for p in range(1, len(octave)):
                q = t["parents"][p]
                hp, wp = grid(part[q], level - octave[q] * interval)
                for f in t["filters"][p]:
                    hc, wc = grid(sizes[f], level - octave[p] * interval)
                    src += hc * wc
                    mid += hp * wc
                    out += hp * wp
    return src, mid, out


def dt_bytes(cfg: dict, images: int = 1) -> float:
    """Bytes of every DT pass of a detect (dt_maps): the y pass reads
    its source (4 bytes a cell) and writes values and pointers (8), the
    x pass reads those values and pointers (8) and writes its own (8)."""
    src, mid, out = dt_maps(cfg)
    return images * float(4 * src + 16 * mid + 8 * out)


def dt_bound_s(cfg: dict, images: int = 1) -> float:
    return dt_bytes(cfg, images) / HBM_BYTES_PER_S


def model_flops(cfg: dict) -> float:
    """FLOPs of one frame by the model's own arithmetic: the exact
    pyramid's correlations (2 per multiply-add, every level and filter
    at its own size, no bucket padding) and the DT passes' envelope
    scans (y and x: DT_OPS_PER_SOURCE a source cell, DT_OPS_PER_OUTPUT
    an output cell). The HOG is not counted."""
    src, mid, out = dt_maps(cfg)
    dt = DT_OPS_PER_SOURCE * (src + mid) + DT_OPS_PER_OUTPUT * (mid + out)
    return float(2 * _conv_counts(cfg)[0] + dt)
