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

`filter_responses_3xtf32_plain` (with `split_tf32`) states the CUDA
kernel's arithmetic, 3xTF32 on the tensor cores, in plain torch: the CPU
tests hold it within 1e-5 * sum|x*w| of `filter_responses`, the rule the
kernel meets on the card.

Filters of different sizes are zero-padded to one (fh, fw): zero taps
contribute nothing, so the valid correlation of a padded filter is the
true response on the shared top-left-anchored grid. Rows and columns
beyond a filter's true valid extent are masked to -inf downstream.

`filter_responses_conv2d` is the library's conv2d in the inputs' dtype,
the conv of the plain bf16 route (bf16 without the f32 re-rank, and the
bf16 miner): there the JAX package runs `lax.conv`, because its Pallas
conv takes f32 only, so no hand kernel lies on that path.

The Fourier engine (`conv_engine="fourier"`) is the port of
`partsbaseddetector_tpu/ops/conv.py::fft_filter_spectra` and the native
branch of `filter_responses_fft`: `torch.fft` transforms (cuFFT on the
card) around a channel contraction of four real f32 batched matrix
products, with the filters' conjugate spectra computed once on the host
in float64. No Pallas kernel lies on that path in the JAX package
either. Its DFT-as-matmul branch (`ops/dft.py`) worked around the TPU
backend's batch-limited FFT and is not carried over.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


def filter_responses_conv2d(features: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """filter_responses' contract through torch's conv2d (cuDNN on the
    card) in the features' dtype: the filters are cast to it. For bf16
    features this is the JAX package's bf16 `lax.conv`."""
    if filters.shape[-1] != features.shape[-1]:
        raise ValueError(
            f"channel mismatch: features {features.shape[-1]}, "
            f"filters {filters.shape[-1]}"
        )
    out = F.conv2d(
        features.permute(0, 3, 1, 2),
        filters.to(features.dtype).permute(0, 3, 1, 2),
    )
    return out.permute(0, 2, 3, 1)


def split_tf32(x: torch.Tensor):
    """(big, small), the 3xTF32 split of f32 x: big = x rounded to TF32
    (10 mantissa bits) to nearest with ties away from zero, as the card's
    `cvt.rna.tf32.f32` does, and small = x - big rounded the same way.
    Both are f32 tensors whose low 13 bits are zero; x - big is exact and
    |x - big - small| <= 2^-22 |x| for normal x. Done on the int32 view:
    adding half of the dropped bits to the magnitude, then clearing them."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    big = rna(x)
    return big, rna(x - big)


def filter_responses_3xtf32_plain(
    features: torch.Tensor, filters: torch.Tensor
) -> torch.Tensor:
    """filter_responses' function with the arithmetic of the K2 kernel
    (csrc/conv_core.cuh): both operands split by split_tf32, each tap's
    sum taken as small*big + big*small + big*big, its pieces' partial
    products exact in f32, then added to the running total. It isolates
    the split's own error: the kernel is held to the same rule, within
    1e-5 * sum|x*w| of filter_responses. Inputs f32; TF32 matmul off."""
    s, h, w, c = features.shape
    f, fh, fw, fc = filters.shape
    if fc != c:
        raise ValueError(f"channel mismatch: features {c}, filters {fc}")
    oh, ow = h - fh + 1, w - fw + 1
    xb, xs = split_tf32(features)
    wb, ws = split_tf32(filters)
    out = torch.zeros((s, oh, ow, f), dtype=torch.float32, device=features.device)
    for i in range(fh):
        for j in range(fw):
            tb = xb[:, i : i + oh, j : j + ow, :].reshape(-1, c)
            ts = xs[:, i : i + oh, j : j + ow, :].reshape(-1, c)
            part = ts @ wb[:, i, j, :].T + tb @ ws[:, i, j, :].T
            part = part + tb @ wb[:, i, j, :].T
            out += part.reshape(s, oh, ow, f)
    return out


# spectra memo keyed on (id(filters), h, w); each entry keeps its filters
# array alive, so an id cannot be recycled while its entry lives
_SPECTRA_CACHE: dict = {}


def fft_filter_spectra(filters: np.ndarray, h: int, w: int) -> np.ndarray:
    """Conjugate filter spectra for an (h, w) transform, on the host:
    float64 rfft2 of the (F, fh, fw, C) bank, rounded once to f32.
    Returns (2, h, w//2 + 1, C, F) float32, [real, imag]. Memoized per
    (filters, h, w)."""
    key = (id(filters), int(h), int(w))
    hit = _SPECTRA_CACHE.get(key)
    if hit is not None:
        return hit[1]
    filt_f = np.conj(
        np.fft.rfft2(
            np.transpose(filters.astype(np.float64), (0, 3, 1, 2)), s=(h, w)
        )
    )  # (F, C, h, wf)
    bt = np.transpose(filt_f, (2, 3, 1, 0))  # (h, wf, C, F)
    out = np.stack([bt.real, bt.imag]).astype(np.float32)
    _SPECTRA_CACHE[key] = (filters, out)
    return out


def filter_responses_fft(
    features: torch.Tensor, filters: torch.Tensor, spectra=None
) -> torch.Tensor:
    """filter_responses' contract through the frequency domain: the
    circular correlation irfft2(rfft2(feat) * conj(rfft2(filt))) is
    exact on the valid (H-fh+1, W-fw+1) grid. Channel spectra are summed
    before one inverse transform per (scale, filter), as four real f32
    (S, C) x (C, F) products per frequency (TF32 must be off, as the
    detector sets it). spectra (optional): fft_filter_spectra's array
    for (H, W), as a tensor on the features' device; without it the
    filters are transformed here in f32, under autograd when they carry
    a graph (the training path: gradients reach the filters through the
    transforms and the products). features may carry a leading
    image axis, (B, S, H, W, C) -> (B, S, oh, ow, F): the spectra are
    broadcast over it, as a batch dimension of the same products, so
    each image's products keep the (S, C) x (C, F) shape, and its
    rounding, that it has alone."""
    single = features.dim() == 4
    if single:
        features = features[None]
    _, _, h, w, c = features.shape
    f, fh, fw, fc = filters.shape
    if fc != c:
        raise ValueError(f"channel mismatch: features {c}, filters {fc}")
    feat_f = torch.fft.rfft2(features.permute(0, 1, 4, 2, 3), s=(h, w))
    if spectra is None:
        filt_f = torch.conj(
            torch.fft.rfft2(filters.permute(0, 3, 1, 2), s=(h, w))
        )
        br = filt_f.real.permute(2, 3, 1, 0)  # (h, wf, C, F)
        bi = filt_f.imag.permute(2, 3, 1, 0)
    else:
        br, bi = spectra[0], spectra[1]
    a = feat_f.permute(0, 3, 4, 1, 2)  # (B, h, wf, S, C)
    re = a.real @ br - a.imag @ bi  # (B, h, wf, S, F)
    im = a.real @ bi + a.imag @ br
    spec = torch.complex(re, im).permute(0, 3, 4, 1, 2)  # (B, S, F, h, wf)
    out = torch.fft.irfft2(spec, s=(h, w))
    out = out[..., : h - fh + 1, : w - fw + 1].permute(0, 1, 3, 4, 2)
    return out[0] if single else out
