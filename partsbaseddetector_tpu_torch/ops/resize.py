"""Pyramid resampling as two banded linear maps in float64.

Port of `partsbaseddetector_tpu/ops/resize.py`. The area resize
(resize.cc) and the 5-tap binomial reduce (reduce.cc) are linear maps;
their exact weights are built on the host once per (src_len, dst_len)
pair. The JAX package applies them as two dense f32 matrix products.
Here each output row (then column) is the sum of its few nonzero taps,
taken as elementwise torch ops in float64 (a gather, a multiply, a
fixed pairwise tree of adds) and rounded to f32 once at the end.

Why not a matrix product: the sum of f32 products in a GEMM is taken in
an order that the library picks from the shapes, and on the card cuBLAS
picks another one for another batch count, so the same image rounded
differently alone and inside a microbatch. Elementwise IEEE operations in
a fixed order give the same bits for any batch, on the CPU and on the
card alike; the float64 sum rounded once makes each resized pixel the
float64-accurate value, within one f32 rounding of the JAX package's.

Images carry a leading image axis, (B, H, W, C): no operation's
rounding depends on B, so a batch of images computes each image exactly
as it computes alone.

bf16 images (the plain bf16 profile) follow the JAX package's bf16
matrix products instead: weights rounded to bf16, each pass's taps
multiplied and summed in f32 and the pass rounded to bf16. `tree_sum`
likewise sums bf16 in f32 and rounds once. Both stay elementwise and
fixed-order, so bf16 features are batch-invariant too.

The device copies of the taps (and of `ops/hog.py`'s constants) live in
bounded caches. A caller may pass `consts`, a dict of its own that
keeps every one it reads (`held`): a captured CUDA graph reads them
long after the call, whatever the caches have dropped since
(`ops/dp_graph.py::PyramidGraph`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.rounding import cround
from . import reference


@functools.lru_cache(maxsize=None)
def resize_matrix(src_len: int, dst_len: int) -> np.ndarray:
    """Dense (dst_len, src_len) area-averaging resample matrix: the
    exact resize.cc weights in float64."""
    return reference.resize_weights(src_len, dst_len)


@functools.lru_cache(maxsize=None)
def reduce_matrix(src_len: int) -> np.ndarray:
    """Dense (round(src/2), src_len) binomial reduce matrix (exact
    reduce.cc boundary stencils) in float64."""
    return reference.reduce_weights(src_len)


def held(consts, key: tuple, make):
    """make(), kept in the dict `consts` under key when a caller passes
    one (and taken from it from then on); without one, make() alone."""
    if consts is None:
        return make()
    if key not in consts:
        consts[key] = make()
    return consts[key]


def device_constant(fn, *key, device, consts=None) -> torch.Tensor:
    """The host matrix fn(*key) as a tensor on `device`, cached so that
    each detect call does not copy the same weights to the card again.
    Bounded: one image size needs a few dozen matrices. With `consts`,
    kept there too (`held`)."""
    device = torch.device(device)
    return held(consts, (fn, key, device),
                lambda: _device_constant(fn, key, device))


@functools.lru_cache(maxsize=512)
def _device_constant(fn, key, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fn(*key), device=device)


@functools.lru_cache(maxsize=None)
def banded(fn, *key) -> tuple:
    """The dense (dst, src) weight matrix fn(*key) as its nonzero taps:
    (idx, wt), each (dst, T), T the widest row's tap count rounded up to
    a power of two; a row's taps in ascending source order, padded with
    weight 0 on source 0. Weights keep fn's dtype (float64 here)."""
    m = np.asarray(fn(*key))
    rows = [np.flatnonzero(r) for r in m]
    width = max([len(r) for r in rows] + [1])
    taps = 1 << (width - 1).bit_length()
    idx = np.zeros((m.shape[0], taps), dtype=np.int64)
    wt = np.zeros((m.shape[0], taps), dtype=m.dtype)
    for d, r in enumerate(rows):
        idx[d, : len(r)] = r
        wt[d, : len(r)] = m[d, r]
    return idx, wt


def apply_banded(x: torch.Tensor, dim: int, fn, *key, consts=None) -> torch.Tensor:
    """out.select(dim, d) = sum_t wt[d, t] * x.select(dim, idx[d, t]) for
    the taps of banded(fn, *key): one gather, one multiply and log2(T)
    adds of halves, in x's dtype. Every operation is elementwise, so the
    result does not depend on the other dimensions' sizes or the device.
    With `consts`, the taps' device copies are kept there too (`held`)."""
    idx, wt = held(consts, (fn, key, x.dtype, x.device),
                   lambda: _device_taps(fn, key, x.dtype, x.device))
    dst, taps = wt.shape
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim : dim + 1] = [dst, taps]
    # bf16 taps are multiplied and summed in f32, rounded once
    acc = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    g = x.index_select(dim, idx).reshape(shape).to(acc)
    g = g * wt.to(acc).reshape([dst, taps] + [1] * (x.dim() - dim - 1))
    return tree_sum(g, dim + 1).to(x.dtype)


def tree_sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` in a fixed order: zeros appended up to a power of
    two, then halves added pairwise. Unlike torch.sum, whose order (and
    so its rounding) may follow the tensor's size, the threads or the
    device, this gives the same bits for a slice in any batch."""
    if t.dtype == torch.bfloat16:
        return tree_sum(t.to(torch.float32), dim).to(t.dtype)
    dim = dim % t.dim()
    n = t.shape[dim]
    p = 1 << (n - 1).bit_length()
    if p != n:
        shape = list(t.shape)
        shape[dim] = p - n
        t = torch.cat([t, t.new_zeros(shape)], dim=dim)
    while p > 1:
        p //= 2
        t = t.narrow(dim, 0, p) + t.narrow(dim, p, p)
    return t.squeeze(dim)


@functools.lru_cache(maxsize=512)
def _device_taps(fn, key: tuple, dtype: torch.dtype, device: torch.device):
    """banded(fn, *key) on `device`, the weights in `dtype`, cached so
    that each detect call does not copy the same taps to the card again."""
    idx, wt = banded(fn, *key)
    return (torch.as_tensor(idx.reshape(-1), device=device),
            torch.as_tensor(wt, device=device).to(dtype))


def _apply_separable(im: torch.Tensor, fn, hkey: tuple, wkey: tuple,
                     consts=None) -> torch.Tensor:
    """(B, H, W, C) -> (B, dh, dw, C): the row map then the column map.
    f32 images: both in float64, rounded to f32 once. bf16 images: each
    pass as the JAX package's bf16 matrix product (apply_banded)."""
    if im.dtype == torch.bfloat16:
        rows = apply_banded(im, 1, fn, *hkey, consts=consts)
        return apply_banded(rows, 2, fn, *wkey, consts=consts)
    out = apply_banded(im.to(torch.float64), 1, fn, *hkey, consts=consts)
    return apply_banded(out, 2, fn, *wkey, consts=consts).to(im.dtype)


def resize_image(im: torch.Tensor, scale: float, consts=None) -> torch.Tensor:
    """Resize (B, H, W, C) f32 or bf16 images by a scale factor <= 1."""
    h, w = im.shape[1:3]
    dh, dw = cround(h * scale), cround(w * scale)
    return _apply_separable(im, resize_matrix, (h, dh), (w, dw), consts)


def reduce_image(im: torch.Tensor, consts=None) -> torch.Tensor:
    """Half-size binomial reduce of (B, H, W, C) f32 or bf16 images."""
    h, w = im.shape[1:3]
    return _apply_separable(im, reduce_matrix, (h,), (w,), consts)
