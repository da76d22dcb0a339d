"""The inputs of a run, made from its seed: the model's weights and the
frames. Both sides of the comparison get these same tensors; nothing
here imports the program.

A model is a pool of filters and one tree a component
(lib/spec.py::trees; the one-tree form is one component over a pool of
parts x mixtures). Weights are drawn on the run's device by one
torch.Generator, in a few calls, in the distribution the reference code
initialises a model with (learning/buildmodel.m: deformations
[0.01 0 0.01 0] and up) widened to random values: first the pool's
filters, N(0, filter_std), made zero-mean in each channel and scaled to
the norm filter_std * sqrt(size) (HOG features are positive, so a
filter's mean and norm would otherwise shift the score scale with the
seed); then each component in turn, per (part, mixture): quadratic
deformation costs uniform in def_quadratic, linear ones
N(0, def_linear_std), anchors uniform in [0, 2 * filter size), biases
N(0, bias_std). Components thus share templates and have springs of
their own, as the shared models of Zhu & Ramanan (CVPR 2012) do. The
trees, the mixture count, the pool and the filter size are the
configuration's, fixed, so every seed does the same work.
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


def model_arrays(cfg: dict, g: torch.Generator, device) -> Dict[str, object]:
    """{"filters": (F, fh, fw, C) f32, the pool, "trees": one dict a
    component}: parent (P,) int64, filterid (P, K) int64 into the pool,
    defs (P, K, 4) f32 as (ax, bx, ay, by), anchors (P, K, 2) int64 as
    (x, y), bias (P, K, K) f32: bias[p, l, k] for parent mixture l and
    mixture k, the root's in bias[0, 0]."""
    pool, trees = spec.trees(cfg)
    k_ = cfg["mixtures"]
    fh, fw, c = cfg["filter_h"], cfg["filter_w"], cfg["hog_channels"]
    w = cfg["weights"]
    lo, hi = w["def_quadratic"]
    kw = dict(generator=g, device=device)
    filters = torch.randn((pool, fh, fw, c), **kw) * w["filter_std"]
    filters = filters - filters.mean(dim=(1, 2), keepdim=True)
    filters = filters * (w["filter_std"] * (fh * fw * c) ** 0.5
                         / filters.square().sum(dim=(1, 2, 3), keepdim=True).sqrt())
    out = []
    for t in trees:
        p_ = len(t["parents"])
        quad = lo + (hi - lo) * torch.rand((p_, k_, 2), **kw)
        lin = torch.randn((p_, k_, 2), **kw) * w["def_linear_std"]
        ax = torch.randint(0, 2 * fw, (p_, k_), **kw)
        ay = torch.randint(0, 2 * fh, (p_, k_), **kw)
        bias = torch.randn((p_, k_, k_), **kw) * w["bias_std"]
        defs = torch.stack([quad[..., 0], lin[..., 0], quad[..., 1], lin[..., 1]], -1)
        out.append({"parent": torch.tensor(t["parents"], dtype=torch.int64, device=device),
                    "filterid": torch.tensor(t["filters"], dtype=torch.int64, device=device),
                    "defs": defs.contiguous(), "anchors": torch.stack([ax, ay], -1),
                    "bias": bias})
    return {"filters": filters.contiguous(), "trees": out}


def frames(cfg: dict, n: int, g: torch.Generator, device) -> List[np.ndarray]:
    """n distinct uint8 RGB frames of the configuration's size, drawn on
    the device in one call and handed out as host arrays, as a camera or
    a decoder hands them to a caller."""
    stack = torch.randint(0, 256, (n, cfg["frame_h"], cfg["frame_w"], 3),
                          dtype=torch.uint8, generator=g, device=device)
    host = stack.cpu().numpy()
    return [host[i] for i in range(n)]
