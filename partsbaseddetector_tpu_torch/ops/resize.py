"""Pyramid resampling as two dense f32 matrix products.

Port of `partsbaseddetector_tpu/ops/resize.py`. The area resize
(resize.cc) and the 5-tap binomial reduce (reduce.cc) are linear maps;
their exact weight matrices are built on the host once per
(src_len, dst_len) pair and applied as a row product then a column
product. On the card the products run in full f32 (`torch.matmul` with
TF32 off, which the detector sets).

Images carry a leading image axis, (B, H, W, C). Each image's products
have the single image's shapes, with B (and the rows of the column
product) as the batch of one batched product, so a batch of images
computes each image exactly as it computes alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.rounding import cround
from . import reference


@functools.lru_cache(maxsize=None)
def resize_matrix(src_len: int, dst_len: int) -> np.ndarray:
    """Dense (dst_len, src_len) area-averaging resample matrix (exact
    resize.cc weights, computed in float64 then cast to f32)."""
    return np.asarray(
        reference.resize_weights(src_len, dst_len), dtype=np.float32
    )


@functools.lru_cache(maxsize=None)
def reduce_matrix(src_len: int) -> np.ndarray:
    """Dense (round(src/2), src_len) binomial reduce matrix (exact
    reduce.cc boundary stencils)."""
    return np.asarray(reference.reduce_weights(src_len), dtype=np.float32)


def device_constant(fn, *key, device) -> torch.Tensor:
    """The host matrix fn(*key) as a tensor on `device`, cached so that
    each detect call does not copy the same weights to the card again.
    Bounded: one image size needs a few dozen matrices."""
    return _device_constant(fn, key, torch.device(device))


@functools.lru_cache(maxsize=512)
def _device_constant(fn, key, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fn(*key), device=device)


def _apply_separable(
    im: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor
) -> torch.Tensor:
    """(B, H, W, C) -> (B, dh, dw, C) via row product then column
    product."""
    b, h, w, c = im.shape
    out = torch.matmul(wh, im.reshape(b, h, w * c)).reshape(b, -1, w, c)
    # contract width with ww: (dw, W) x (B, dh, W, C) -> (B, dh, dw, C)
    return torch.matmul(ww, out)


def resize_image(im: torch.Tensor, scale: float) -> torch.Tensor:
    """Resize (B, H, W, C) f32 images by a scale factor <= 1."""
    h, w = im.shape[1:3]
    dh, dw = cround(h * scale), cround(w * scale)
    dev = im.device
    return _apply_separable(
        im,
        device_constant(resize_matrix, h, dh, device=dev),
        device_constant(resize_matrix, w, dw, device=dev),
    )


def reduce_image(im: torch.Tensor) -> torch.Tensor:
    """Half-size binomial reduce of (B, H, W, C) f32 images."""
    h, w = im.shape[1:3]
    dev = im.device
    return _apply_separable(
        im,
        device_constant(reduce_matrix, h, device=dev),
        device_constant(reduce_matrix, w, device=dev),
    )
