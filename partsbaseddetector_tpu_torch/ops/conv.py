"""Part-filter responses: the plain version of the K2 port.

`filter_responses` is the valid multichannel correlation of a filter
bank in f32, the counterpart of `partsbaseddetector_tpu/ops/conv.py::
filter_responses`. It is one f32 matrix product per filter tap, so no
cuDNN algorithm choice (FFT, Winograd, TF32) can enter and the sums stay
in f32 on either device, provided TF32 matmul is off (the detector and
the train step turn it off). It serves the CPU path, is what the CUDA
kernel (ops/conv_cuda.py) is held against, and is the training path's
conv on every device: autograd differentiates it in the filters, as the
JAX package's training differentiates its XLA conv.

Filters of different sizes are zero-padded to one (fh, fw): zero taps
contribute nothing, so the valid correlation of a padded filter is the
true response on the shared top-left-anchored grid. Rows and columns
beyond a filter's true valid extent are masked to -inf downstream.
"""

from __future__ import annotations

import torch


def filter_responses(features: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """features (S, H, W, C), filters (F, fh, fw, C) ->
    (S, H-fh+1, W-fw+1, F); out[s,y,x,f] = sum feat[s,y+i,x+j,c]*filt[f,i,j,c]."""
    s, h, w, c = features.shape
    f, fh, fw, fc = filters.shape
    if fc != c:
        raise ValueError(f"channel mismatch: features {c}, filters {fc}")
    oh, ow = h - fh + 1, w - fw + 1
    out = torch.zeros((s, oh, ow, f), dtype=features.dtype, device=features.device)
    for i in range(fh):
        for j in range(fw):
            tap = features[:, i : i + oh, j : j + ow, :].reshape(-1, c)
            out += (tap @ filters[:, i, j, :].T).reshape(s, oh, ow, f)
    return out
