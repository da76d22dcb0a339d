"""The inputs of a run, made from its seed: the model's weights and the
frames. Both sides of the comparison get these same tensors; nothing
here imports the program.

A model is a pool of filters and one tree a component
(lib/spec.py::trees; the one-tree form is one component over a pool of
parts x mixtures). Weights are drawn on the run's device by one
torch.Generator, in a few calls, in the distribution the reference code
initialises a model with (learning/buildmodel.m: deformations
[0.01 0 0.01 0] and up) widened to random values: first the pool's
filters, one call a filter size in the order the pool first names it,
N(0, filter_std), each made zero-mean in each channel and scaled to the
norm filter_std * sqrt(its own size) (HOG features are positive, so a
filter's mean and norm would otherwise shift the score scale with the
seed); then each component in turn, per (part, mixture): quadratic
deformation costs uniform in def_quadratic, linear ones
N(0, def_linear_std), anchors, biases N(0, bias_std). An anchor is
uniform in [0, 2 * the part's filter size) on its parent's level; one
octave finer (ds = 1), uniform over the placements that keep the part
inside its parent's footprint at twice the resolution, [0, 2 * the
parent's size - the part's size] (the parent's smallest mixture's).
Components thus share templates and have springs of their own, as the
shared models of Zhu & Ramanan (CVPR 2012) do. The trees, the mixture
count, the pool and the filter sizes are the configuration's, fixed, so
every seed does the same work.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import spec


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _filters(sizes, c: int, std: float, kw) -> torch.Tensor:
    """The pool, (F, fh_max, fw_max, C), each filter at its own size in
    the bank's top-left corner and zeros beyond it."""
    def draw(n, fh, fw):
        f = torch.randn((n, fh, fw, c), **kw) * std
        f = f - f.mean(dim=(1, 2), keepdim=True)
        return f * (std * (fh * fw * c) ** 0.5 / f.square().sum(dim=(1, 2, 3), keepdim=True).sqrt())

    order = list(dict.fromkeys(sizes))
    bank = torch.zeros((len(sizes), max(h for h, _ in order), max(w for _, w in order), c),
                       device=kw["device"])
    for fh, fw in order:
        rows = [i for i, size in enumerate(sizes) if size == (fh, fw)]
        bank[rows, :fh, :fw] = draw(len(rows), fh, fw)
    return bank


def _uniform(high: np.ndarray, kw) -> torch.Tensor:
    """Integers uniform in [0, high), one an entry of `high` (P, K): one
    randint where every entry has the same high."""
    if (high == high.flat[0]).all():
        return torch.randint(0, int(high.flat[0]), high.shape, **kw)
    u = torch.rand(high.shape, dtype=torch.float64, **kw)
    top = torch.as_tensor(high, device=kw["device"])
    return torch.minimum((u * top).floor().to(torch.int64), top - 1)


def _anchor_highs(t: dict, sizes, axis: int) -> np.ndarray:
    """(P, K) exclusive highs of one anchor axis (0: y by heights, 1: x by
    widths): 2 * the part's size on its parent's level, 2 * the parent's
    smallest mixture's size - the part's + 1 one octave finer."""
    own = np.array([[sizes[f][axis] for f in row] for row in t["filters"]])
    parent = own.min(axis=1)[t["parents"]][:, None]
    finer = np.maximum(2 * parent - own, 0) + 1
    return np.where(np.array(t["ds"])[:, None] == 1, finer, 2 * own)


def model_arrays(cfg: dict, g: torch.Generator, device) -> Dict[str, object]:
    """{"filters": (F, fh_max, fw_max, C) f32, the pool, each filter in
    its top-left (fh, fw) and zeros beyond, "sizes": (F, 2) int64 as
    (fh, fw), "maxsize": (h, w) the padding's, "trees": one dict a
    component}: parent (P,) int64, filterid (P, K) int64 into the pool,
    ds (P,) int64 each part's octave below its parent, defs (P, K, 4)
    f32 as (ax, bx, ay, by), anchors (P, K, 2) int64 as (x, y), bias
    (P, K, K) f32: bias[p, l, k] for parent mixture l and mixture k, the
    root's in bias[0, 0]."""
    pool, trees = spec.trees(cfg)
    sizes = spec.filter_sizes(cfg)
    k_ = cfg["mixtures"]
    w = cfg["weights"]
    lo, hi = w["def_quadratic"]
    kw = dict(generator=g, device=device)
    filters = _filters(sizes, cfg["hog_channels"], w["filter_std"], kw)
    i64 = lambda x: torch.tensor(x, dtype=torch.int64, device=device)
    out = []
    for t in trees:
        p_ = len(t["parents"])
        quad = lo + (hi - lo) * torch.rand((p_, k_, 2), **kw)
        lin = torch.randn((p_, k_, 2), **kw) * w["def_linear_std"]
        ax = _uniform(_anchor_highs(t, sizes, 1), kw)
        ay = _uniform(_anchor_highs(t, sizes, 0), kw)
        bias = torch.randn((p_, k_, k_), **kw) * w["bias_std"]
        defs = torch.stack([quad[..., 0], lin[..., 0], quad[..., 1], lin[..., 1]], -1)
        out.append({"parent": i64(t["parents"]), "filterid": i64(t["filters"]),
                    "ds": i64(t["ds"]), "defs": defs.contiguous(),
                    "anchors": torch.stack([ax, ay], -1), "bias": bias})
    return {"filters": filters.contiguous(), "sizes": i64(sizes),
            "maxsize": spec.maxsize(cfg), "trees": out}


def frames(cfg: dict, n: int, g: torch.Generator, device) -> List[np.ndarray]:
    """n distinct uint8 RGB frames of the configuration's size, drawn on
    the device in one call and handed out as host arrays, as a camera or
    a decoder hands them to a caller."""
    stack = torch.randint(0, 256, (n, cfg["frame_h"], cfg["frame_w"], 3),
                          dtype=torch.uint8, generator=g, device=device)
    host = stack.cpu().numpy()
    return [host[i] for i in range(n)]
