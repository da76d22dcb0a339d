"""Forward pipeline: image -> root score maps + DP pointer tables.

Port of `partsbaseddetector_tpu/pipeline.py` (`make_plan`,
`root_scores`) for inference with the spatial engine: HOG pyramid ->
part-filter responses (the K2 kernel on the card) -> valid-extent -inf
masking -> tree min-sum DP (the K1 kernel on the card) for every
(bucket, component) pair. The trainable form (params, -1e10 masking),
response gates (RGB-D) and the Fourier engine belong to later slices.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .models.model import DeviceModel, PackedModel
from .ops.conv_cuda import filter_responses_infer
from .ops.dp import tree_min_sum
from .ops.pyramid import (
    PyramidPlan,
    build_plan,
    build_pyramid_features,
    mask_responses,
    response_valid_extents,
)


class BucketScores(NamedTuple):
    """Root scores for one (bucket, component) pair."""

    bucket_index: int
    component: int
    rootv: torch.Tensor  # (S, Hr, Wr)
    rooti: torch.Tensor  # (S, Hr, Wr) int32
    tables: Dict[int, torch.Tensor]


def make_plan(
    packed: PackedModel, imsize: Tuple[int, int], buckets_per_octave: int = 1
) -> PyramidPlan:
    fh_max, fw_max = packed.filters.shape[1], packed.filters.shape[2]
    return build_plan(
        imsize, packed.spec, fh_max, fw_max, buckets_per_octave
    )


def root_scores(
    im: torch.Tensor,
    packed: PackedModel,
    dmodel: DeviceModel,
    plan: PyramidPlan,
) -> List[BucketScores]:
    """Run HOG pyramid -> responses -> tree DP for every (bucket,
    component). im: (H, W, 3) on dmodel's device, any real dtype (cast
    to f32 here, so a uint8 frame computes exactly as its f32 copy)."""
    spec = packed.spec
    feats = build_pyramid_features(im.to(torch.float32), plan, spec)

    resps: List[torch.Tensor] = []
    vhs: List[np.ndarray] = []
    vws: List[np.ndarray] = []
    for b, bucket in enumerate(plan.buckets):
        resp = filter_responses_infer(feats[b], dmodel.filters)
        vh, vw = response_valid_extents(
            plan, bucket, packed.filter_sizes, spec.border
        )
        resps.append(mask_responses(resp, vh, vw, -math.inf))
        vhs.append(vh)
        vws.append(vw)

    bpo = (
        spec.interval // len(plan.buckets[0].scale_indices)
        if plan.buckets[0].scale_indices
        else 1
    )
    out: List[BucketScores] = []
    for b in range(len(plan.buckets)):
        for c, comp in enumerate(packed.components):
            if b < comp.max_ds * bpo:
                # some part's octave-finer level would not exist at this
                # root scale (detect_fast.m level bound)
                continue
            rootv, rooti, tables = tree_min_sum(
                resps,
                comp,
                dmodel.components[c],
                valid_extents=(vhs, vws),
                bucket_index=b,
                buckets_per_octave=bpo,
            )
            out.append(BucketScores(b, c, rootv, rooti, tables))
    return out
