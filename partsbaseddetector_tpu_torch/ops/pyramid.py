"""HOG feature pyramid: host plan + torch builder.

Port of `partsbaseddetector_tpu/ops/pyramid.py`. The reference builds
its pyramid with interval-many fractional resizes followed by repeated
2x reductions (src/HOGFeatures.cpp:109-127, featpyramid.m:24-34), pads
each level and writes the boundary occlusion channel
(featpyramid.m:36-45). Scale count:
nscales = 1 + floor(log(min(H,W)/(5*sbin)) / log(2^(1/interval))).

The ragged pyramid is planned on the host (`build_plan`, a NumPy copy):
exact per-scale shapes follow the reference's rounding chain, and
scales are grouped into buckets padded to one shape, so the conv and
the DP run as one batched call per bucket. Bucket padding is dead: the
valid-extent masks turn it to -inf after the response stage.

Bucket feature shapes add (fh_max-1, fw_max-1): filters are zero-padded
to one size for the batched conv, and the extra margin makes the shared
valid-conv grid cover every filter's true valid extent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.model import ModelSpec
from ..utils.rounding import cround
from .hog import hog_features
from .resize import reduce_image, resize_image


@dataclasses.dataclass(frozen=True)
class ScaleInfo:
    index: int
    im_h: int
    im_w: int
    feat_h: int  # HOG output rows (bh-2)
    feat_w: int
    pad_h: int  # meaningful padded rows = feat_h + 2*(pady+1)
    pad_w: int
    box_scale: float  # image pixels per feature cell at this scale


@dataclasses.dataclass(frozen=True)
class BucketInfo:
    scale_indices: Tuple[int, ...]
    feat_h: int  # common padded feature height (incl. conv margin)
    feat_w: int
    resp_h: int  # feat_h - fh_max + 1
    resp_w: int


@dataclasses.dataclass(frozen=True)
class PyramidPlan:
    imsize: Tuple[int, int]
    nscales: int
    scales: Tuple[ScaleInfo, ...]
    buckets: Tuple[BucketInfo, ...]
    buckets_per_octave: int = 1


def build_plan(
    imsize: Tuple[int, int],
    spec: ModelSpec,
    fh_max: int,
    fw_max: int,
    buckets_per_octave: int = 1,
) -> PyramidPlan:
    """buckets_per_octave > 1 splits each octave into finer buckets:
    less padding waste in the batched conv/DT at the cost of more calls.
    Must divide the interval. A part d octaves down reads bucket
    b - d*buckets_per_octave."""
    if spec.interval % buckets_per_octave:
        raise ValueError("buckets_per_octave must divide the interval")
    h, w = imsize
    sc = 2.0 ** (1.0 / spec.interval)
    nscales = 1 + int(
        math.floor(math.log(min(h, w) / (5.0 * spec.sbin)) / math.log(sc))
    )
    if nscales < 1:
        raise ValueError(f"image {imsize} too small for sbin={spec.sbin}")

    sizes: List[Tuple[int, int]] = [None] * nscales
    for i in range(spec.interval):
        if i >= nscales:
            break
        f = 1.0 / (sc**i)
        sizes[i] = (cround(h * f), cround(w * f))
        j = i + spec.interval
        while j < nscales:
            ph, pw = sizes[j - spec.interval]
            sizes[j] = (cround(ph * 0.5), cround(pw * 0.5))
            j += spec.interval

    scales: List[ScaleInfo] = []
    for s in range(nscales):
        ih, iw = sizes[s]
        bh, bw = cround(ih / spec.sbin), cround(iw / spec.sbin)
        fh, fw = max(bh - 2, 0), max(bw - 2, 0)
        octave, frac = divmod(s, spec.interval)
        box_scale = spec.sbin * (sc**frac) * (2.0**octave)
        scales.append(
            ScaleInfo(
                index=s,
                im_h=ih,
                im_w=iw,
                feat_h=fh,
                feat_w=fw,
                pad_h=fh + 2 * (spec.pady + 1),
                pad_w=fw + 2 * (spec.padx + 1),
                box_scale=box_scale,
            )
        )

    buckets: List[BucketInfo] = []
    bsz = spec.interval // buckets_per_octave
    for start in range(0, nscales, bsz):
        idxs = tuple(range(start, min(start + bsz, nscales)))
        max_h = max(scales[i].pad_h for i in idxs)
        max_w = max(scales[i].pad_w for i in idxs)
        feat_h = max_h + fh_max - 1
        feat_w = max_w + fw_max - 1
        buckets.append(
            BucketInfo(
                scale_indices=idxs,
                feat_h=feat_h,
                feat_w=feat_w,
                resp_h=feat_h - fh_max + 1,
                resp_w=feat_w - fw_max + 1,
            )
        )
    return PyramidPlan(
        imsize=imsize,
        nscales=nscales,
        scales=tuple(scales),
        buckets=tuple(buckets),
        buckets_per_octave=buckets_per_octave,
    )


def _pad_feature(
    feat: torch.Tensor, spec: ModelSpec, bucket: BucketInfo
) -> torch.Tensor:
    """Apply the meaningful (pady+1, padx+1) padding with the boundary
    occlusion channel (featpyramid.m:36-45), then zero-align to the
    bucket shape. feat: (B, h, w, C)."""
    py, px = spec.pady + 1, spec.padx + 1
    f = F.pad(feat, (0, 0, px, px, py, py))
    ph, pw = f.shape[1:3]
    dev = f.device
    row = torch.arange(ph, device=dev)[:, None]
    col = torch.arange(pw, device=dev)[None, :]
    border = (row < py) | (row >= ph - py) | (col < px) | (col >= pw - px)
    occ = torch.where(border, torch.ones((), dtype=f.dtype, device=dev), f[..., -1])
    f = torch.cat([f[..., :-1], occ[..., None]], dim=-1)
    return F.pad(f, (0, 0, 0, bucket.feat_w - pw, 0, bucket.feat_h - ph))


def _scale_images(
    im: torch.Tensor, plan: PyramidPlan, spec: ModelSpec, consts=None
) -> List[torch.Tensor]:
    sc = 2.0 ** (1.0 / spec.interval)
    images: List[torch.Tensor] = [None] * plan.nscales
    for i in range(min(spec.interval, plan.nscales)):
        scaled = resize_image(im, 1.0 / (sc**i), consts) if i > 0 else im
        images[i] = scaled
        j = i + spec.interval
        while j < plan.nscales:
            scaled = reduce_image(scaled, consts)
            images[j] = scaled
            j += spec.interval
    return images


def build_pyramid_features(
    im: torch.Tensor, plan: PyramidPlan, spec: ModelSpec, consts=None
) -> List[torch.Tensor]:
    """HOG features for every scale, returned as one padded
    (B, S_b, H_b, W_b, flen) stack per bucket. im: (B, H, W, 3) f32.
    consts (optional): a dict that keeps every device constant the
    pyramid reads (ops/resize.py::held), as a captured graph needs."""
    images = _scale_images(im, plan, spec, consts)
    feats = [hog_features(images[s], spec.sbin, consts) for s in range(plan.nscales)]
    return [
        torch.stack(
            [_pad_feature(feats[s], spec, bucket) for s in bucket.scale_indices],
            dim=1,
        )
        for bucket in plan.buckets
    ]


class PyramidKernels:
    """The kernels that `ops/reference_pipeline.feature_pyramid` calls
    (resize, reduce, hog), run by the port's pyramid ops on one device.

    feature_pyramid(im, model, kernels=PyramidKernels(device)) then
    builds the features this module's pyramid builds for the detect
    pipeline (f32 images, each level resized from the f32 one before it,
    f32 HOG), bit for bit on the card and on the CPU, as float64 NumPy
    arrays in the reference's unpadded-then-padded layout. They follow
    the float64 NumPy reference to f32 rounding, apart from HOG cells
    whose orientation choice is a near-tie, and take a fraction of its
    time: the reference's loop HOG and three-operand einsum resize need
    minutes for a 240x320 frame at person26's sbin 4 and interval 10.
    The images between calls stay on the device as (1, H, W, 3) f32
    tensors."""

    def __init__(self, device):
        self.device = torch.device(device)

    def _image(self, im) -> torch.Tensor:
        if isinstance(im, torch.Tensor):
            return im
        return torch.as_tensor(
            np.asarray(im, dtype=np.float32), device=self.device
        )[None]

    def resize(self, im, scale: float) -> torch.Tensor:
        return resize_image(self._image(im), scale)

    def reduce(self, im) -> torch.Tensor:
        return reduce_image(self._image(im))

    def hog(self, im, sbin: int) -> np.ndarray:
        feat = hog_features(self._image(im), sbin)[0]
        return feat.to(torch.float64).cpu().numpy()


def response_valid_extents(
    plan: PyramidPlan, bucket: BucketInfo, filter_sizes: np.ndarray,
    border: str = "matlab",
) -> Tuple[np.ndarray, np.ndarray]:
    """(S, F) true valid response extents.

    matlab: padded_size - fsize + 1 per filter (valid correlation);
    cpp: the 'same'-size grid equals the unpadded feature extent for
    every filter (anchor-offset filter placement aligns them)."""
    nf = filter_sizes.shape[0]
    if border == "cpp":
        fh_ = np.array([plan.scales[s].feat_h for s in bucket.scale_indices])
        fw_ = np.array([plan.scales[s].feat_w for s in bucket.scale_indices])
        vh = np.repeat(fh_[:, None], nf, axis=1)
        vw = np.repeat(fw_[:, None], nf, axis=1)
        return vh.astype(np.int32), vw.astype(np.int32)
    fh = filter_sizes[:, 0][None, :]
    fw = filter_sizes[:, 1][None, :]
    ph = np.array([plan.scales[s].pad_h for s in bucket.scale_indices])[:, None]
    pw = np.array([plan.scales[s].pad_w for s in bucket.scale_indices])[:, None]
    return (ph - fh + 1).astype(np.int32), (pw - fw + 1).astype(np.int32)


def mask_responses(
    resp: torch.Tensor, vh: np.ndarray, vw: np.ndarray,
    neg: float = -math.inf,
) -> torch.Tensor:
    """Set response entries outside each (scale, filter) valid extent to
    `neg` so padded regions can never win any downstream max. Inference
    uses -inf. resp: (..., S, Hr, Wr, F), the extents broadcast over
    the leading (image) axes."""
    hr, wr = resp.shape[-3], resp.shape[-2]
    my = np.arange(hr)[None, :, None] < np.asarray(vh)[:, None, :]  # (S,hr,F)
    mx = np.arange(wr)[None, :, None] < np.asarray(vw)[:, None, :]  # (S,wr,F)
    my = torch.as_tensor(my, device=resp.device)
    mx = torch.as_tensor(mx, device=resp.device)
    mask = my[:, :, None, :] & mx[:, None, :, :]
    return torch.where(mask, resp, torch.full((), neg, dtype=resp.dtype, device=resp.device))
