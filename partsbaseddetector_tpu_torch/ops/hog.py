"""32-channel Felzenszwalb HOG as dense torch ops (no scatters).

Port of `partsbaseddetector_tpu/ops/hog.py::hog_features`. The
trilinear cell binning of features.cc is a fixed 2*sbin tent filter
applied with stride sbin to the (orientation one-hot x magnitude) map,
so the histogram stage is two banded linear maps (the JAX package's two
matrix products), each summed tap by tap in a fixed order
(`ops/resize.py::apply_banded`); everything after it is elementwise math,
slicing and fixed-order sums (`tree_sum`), so no rounding depends on the
batch, the threads or the device. The square roots are the correctly
rounded f32 ones on both devices (`sqrt_f32`), and the block norms'
inverse square roots are 1 / sqrt, a correctly rounded division of them.

Semantics kept from the reference (ops/reference.py::hog):
  - gradients from the color channel with the strongest magnitude,
    first channel winning ties (R, G, B order);
  - 18-way orientation snapping with the interleaved (dot, -dot)
    first-max tie rule;
  - pixels on the visible round(dim/sbin)*sbin grid, reads clamped to
    dim-2;
  - output (bh-2, bw-2, 32): 18 contrast-sensitive + 9 insensitive +
    4 texture-energy + 1 zero occlusion channel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.rounding import cround
from . import reference
from .resize import apply_banded, device_constant, tree_sum

NORIENT = 18
FLEN = 32


@functools.lru_cache(maxsize=None)
def _tent_kernel(sbin: int) -> np.ndarray:
    """1-D trilinear scatter weights as a gather filter: for cell c the
    contributing pixels are y = c*sbin - pad + u, u in [0, 2*sbin),
    pad = floor((sbin+1)/2), weighted by tent(t), t = (u + 0.5 -
    pad)/sbin + 0.5 (features.cc:111-119)."""
    pad = (sbin + 1) // 2
    u = np.arange(2 * sbin, dtype=np.float64)
    t = (u + 0.5 - pad) / sbin + 0.5
    return np.where(t < 1.0, t, 2.0 - t)


@functools.lru_cache(maxsize=None)
def _hist_matrix(blocks: int, vlen: int, sbin: int) -> np.ndarray:
    """(blocks, vlen) strided tent-aggregation matrix: row c carries the
    2*sbin tent weights at pixel positions c*sbin - pad + u."""
    pad = (sbin + 1) // 2
    k = _tent_kernel(sbin)
    m = np.zeros((blocks, vlen), dtype=np.float32)
    for c in range(blocks):
        for u in range(2 * sbin):
            y = c * sbin - pad + u
            if 0 <= y < vlen:
                m[c, y] = k[u]
    return m


def _orientation_units() -> np.ndarray:
    return np.stack([reference.HOG_UU, reference.HOG_VV]).astype(np.float32)


def hog_choices(im: torch.Tensor, sbin: int, consts=None):
    """The discrete choices of the HOG of (B, H, W, 3) f32 images, per
    pixel of the visible grid's interior, (B, vh-2, vw-2) each: the
    colour channel with the strongest gradient (first of R, G, B at a
    tie), the snapped orientation in [0, 18), and the chosen gradient's
    squared magnitude. consts: as in ops/resize.py::held."""
    _, h, w, _ = im.shape
    vh, vw = cround(h / sbin) * sbin, cround(w / sbin) * sbin
    dev = im.device

    # --- gradients on the interior grid, edge-replicated to the visible
    # grid: grad maps cover pixel coords y in [1, h-2], x in [1, w-2]
    dy = im[:, 2:, 1:-1, :] - im[:, :-2, 1:-1, :]  # (B, h-2, w-2, 3)
    dx = im[:, 1:-1, 2:, :] - im[:, 1:-1, :-2, :]
    ry = torch.arange(vh - 2, device=dev).clamp(max=h - 3)
    rx = torch.arange(vw - 2, device=dev).clamp(max=w - 3)
    dy = dy[:, ry][:, :, rx]
    dx = dx[:, ry][:, :, rx]

    v3 = dx * dx + dy * dy  # (B, vh-2, vw-2, 3)
    ci = torch.argmax(v3, dim=-1, keepdim=True)  # first max: R, G, B
    gdx = torch.gather(dx, -1, ci)[..., 0]
    gdy = torch.gather(dy, -1, ci)[..., 0]
    gv = torch.gather(v3, -1, ci)[..., 0]

    # --- orientation snapping: interleave (dot_o, -dot_o) so argmax's
    # first-max rule reproduces the reference's comparison order
    # in the image's dtype, as the JAX package's (bf16 dots for bf16)
    units = device_constant(_orientation_units, device=dev, consts=consts)
    units = units.to(im.dtype)
    dots = gdx[..., None] * units[0] + gdy[..., None] * units[1]  # (.., 9)
    inter = torch.stack([dots, -dots], dim=-1).reshape(*dots.shape[:-1], 18)
    idx = torch.argmax(inter, dim=-1)
    best_o = (idx >> 1) + (NORIENT // 2) * (idx & 1)
    return ci[..., 0], best_o, gv


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """sqrt of x taken in f32 and correctly rounded, then rounded to x's
    dtype: the same bits on the CPU and on the card, whatever the thread
    count and whichever call it is. On the CPU torch.sqrt may go through
    a vector math library whose accuracy mode is not fixed: a process's
    first call has been seen up to 3,895 ulp off on a few thousand
    pixels, and later calls 1 ulp off on some. NumPy's sqrt is the IEEE
    one. CUDA's sqrtf is correctly rounded, so the card keeps torch."""
    w = x.to(torch.float32)
    if w.device.type == "cpu":
        r = torch.from_numpy(np.sqrt(w.numpy()))
    else:
        r = torch.sqrt(w)
    return r.to(x.dtype)


def rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt_f32(x) in f32, both steps correctly rounded, so again the
    same bits on every device and call (neither torch.rsqrt on the CPU
    nor CUDA's rsqrtf is correctly rounded), rounded to x's dtype."""
    r = sqrt_f32(x.to(torch.float32))
    if r.device.type == "cpu":
        inv = torch.from_numpy(np.float32(1.0) / r.numpy())
    else:
        inv = torch.ones_like(r) / r
    return inv.to(x.dtype)


def hog_features(im: torch.Tensor, sbin: int, consts=None) -> torch.Tensor:
    """HOG of (B, H, W, 3) f32 images -> (B, bh-2, bw-2, 32) features.
    No operation's rounding depends on B (the tent maps are fixed-order
    elementwise sums, ops/resize.py), so an image computes exactly as it
    does alone. consts: as in ops/resize.py::held."""
    nb, h, w, _ = im.shape
    bh = cround(h / sbin)
    bw = cround(w / sbin)
    oh, ow = max(bh - 2, 0), max(bw - 2, 0)
    vh, vw = bh * sbin, bw * sbin
    dev, dtype = im.device, im.dtype
    _, best_o, gv = hog_choices(im, sbin, consts)

    mag = sqrt_f32(gv)
    onehot = F.one_hot(best_o, NORIENT).to(dtype) * mag[..., None]

    # --- histogram stage: the interior map back on the full pixel frame
    # (border pixels contribute nothing), cells aggregated by two
    # separable strided tent maps, each a fixed sum of its 2*sbin taps
    onehot = F.pad(onehot, (0, 0, 1, 1, 1, 1))  # -> (B, vh, vw, 18)
    tmp = apply_banded(onehot, 1, _hist_matrix, bh, vh, sbin, consts=consts)
    hist = apply_banded(tmp, 2, _hist_matrix, bw, vw, sbin, consts=consts)  # (B, bh, bw, 18)

    # --- block energy and 2x2 neighborhood sums
    half = NORIENT // 2
    norm = tree_sum(torch.square(hist[..., :half] + hist[..., half:]), -1)
    s2 = (norm[:, :-1, :-1] + norm[:, :-1, 1:] + norm[:, 1:, :-1]
          + norm[:, 1:, 1:])
    inv = rsqrt_f32(s2 + reference.HOG_EPS)
    n1 = inv[:, 1 : 1 + oh, 1 : 1 + ow]
    n2 = inv[:, 0:oh, 1 : 1 + ow]
    n3 = inv[:, 1 : 1 + oh, 0:ow]
    n4 = inv[:, 0:oh, 0:ow]
    ns = torch.stack([n1, n2, n3, n4], dim=-1)  # (B, oh, ow, 4)

    src = hist[:, 1 : 1 + oh, 1 : 1 + ow, :]  # (B, oh, ow, 18)
    hclamp = torch.clamp(src[..., None] * ns[..., None, :], max=0.2)
    sensitive = 0.5 * tree_sum(hclamp, -1)
    texture = 0.2357 * tree_sum(hclamp, -2)  # (B, oh, ow, 4)

    ssum = src[..., :half] + src[..., half:]
    insens = 0.5 * tree_sum(torch.clamp(ssum[..., None] * ns[..., None, :], max=0.2), -1)

    occl = torch.zeros((nb, oh, ow, 1), dtype=dtype, device=dev)
    return torch.cat([sensitive, insens, texture, occl], dim=-1)
