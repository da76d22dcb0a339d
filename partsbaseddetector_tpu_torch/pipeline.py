"""Forward pipeline: image -> root score maps + DP pointer tables.

Port of `partsbaseddetector_tpu/pipeline.py` (`make_plan`,
`root_scores`, `max_root_score`, `build_root_masks`) with the spatial
engine: HOG pyramid -> part-filter responses -> valid-extent masking ->
tree min-sum DP for every (bucket, component) pair.

  - inference (params=None): the K2 kernel on the card for the
    responses, -inf masking, the DT kernel (K1) without a backward;
  - training (params = {'filters', 'defs', 'biases'} torch tensors): the
    plain conv (`ops/conv.py::filter_responses`) under autograd, -1e10
    masking, and the DTs with K4's backward, so the root scores are
    differentiable in every pool. The HOG pyramid runs without a graph:
    the image gets no gradient.

Response gates (RGB-D) and the Fourier engine belong to later slices.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from .models.model import DeviceModel, PackedModel
from .ops.conv import filter_responses
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
    params: Optional[dict] = None,
    engine: str = "spatial",
    with_tables: bool = True,
    remat: bool = False,
) -> List[BucketScores]:
    """Run HOG pyramid -> responses -> tree DP for every (bucket,
    component). im: (H, W, 3) on dmodel's device, any real dtype (cast
    to f32 here, so a uint8 frame computes exactly as its f32 copy).
    params (optional): trainable pools on the same device (see the
    module docstring). with_tables=False drops the pointer tables.
    remat=True (with params, without tables) recomputes the DP block in
    the backward pass instead of keeping its intermediates
    (`torch.utils.checkpoint`, the JAX package's `jax.checkpoint`)."""
    if engine == "fourier":
        raise NotImplementedError("the Fourier engine is not ported yet")
    if engine != "spatial":
        raise ValueError(f"unknown conv engine: {engine}")
    spec = packed.spec
    with torch.no_grad():
        feats = build_pyramid_features(im.to(torch.float32), plan, spec)

    neg = -math.inf if params is None else -1e10
    resps: List[torch.Tensor] = []
    vhs: List[np.ndarray] = []
    vws: List[np.ndarray] = []
    for b, bucket in enumerate(plan.buckets):
        if params is None:
            resp = filter_responses_infer(feats[b], dmodel.filters)
        else:
            resp = filter_responses(feats[b], params["filters"])
        vh, vw = response_valid_extents(
            plan, bucket, packed.filter_sizes, spec.border
        )
        resps.append(mask_responses(resp, vh, vw, neg))
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

            def run(resps_, tensors_, comp=comp, c=c, b=b):
                return tree_min_sum(
                    resps_,
                    comp,
                    dmodel.components[c],
                    valid_extents=(vhs, vws),
                    bucket_index=b,
                    buckets_per_octave=bpo,
                    tensors=tensors_,
                )

            tensors = comp.tensors(params) if params is not None else None
            if params is not None and not with_tables and remat:
                rootv, rooti, _ = torch.utils.checkpoint.checkpoint(
                    run, resps, tensors, use_reentrant=False
                )
                tables = {}
            else:
                rootv, rooti, tables = run(resps, tensors)
                if not with_tables:
                    tables = {}
            out.append(BucketScores(b, c, rootv, rooti, tables))
    return out


def max_root_score(
    im: torch.Tensor,
    packed: PackedModel,
    dmodel: DeviceModel,
    plan: PyramidPlan,
    params: Optional[dict] = None,
    root_masks: Optional[List] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Best detection score anywhere in the image (differentiable in
    params).

    root_masks (optional): per-bucket (S_b, Hr, Wr) bool arrays or
    tensors restricting the max to ground-truth-overlapping root
    placements, the latent-positive constraint of the SSVM (detect.m
    testoverlap). Excluded placements score -1e10 (detect.m's INF), so
    the hinge stays finite when no placement qualifies."""
    scores = root_scores(
        im, packed, dmodel, plan, params, with_tables=False, remat=remat
    )
    return max_of_scores(scores, root_masks)


def max_of_scores(scores: List[BucketScores], root_masks=None) -> torch.Tensor:
    """The max over every bucket's root map, optionally restricted by
    per-bucket root masks (see max_root_score). Ties share the gradient
    equally, as jnp.max's does."""
    best = []
    for s in scores:
        rv = s.rootv
        if root_masks is not None:
            m = torch.as_tensor(root_masks[s.bucket_index], device=rv.device)
            rv = torch.where(m, rv, torch.full((), -1e10, device=rv.device))
        best.append(rv.max())
    return torch.stack(best).max()


def build_root_masks(
    packed: PackedModel,
    plan: PyramidPlan,
    bbox: np.ndarray,
    overlap: float = 0.5,
) -> List[np.ndarray]:
    """Host-side per-bucket root-placement masks: positions whose root
    window (largest root filter) has IoU >= overlap with bbox
    (detect.m:338-375). Returns one (S_b, Hr, Wr) bool array per bucket."""
    from .ops.reference_pipeline import overlap_mask

    spec = packed.spec
    comp = packed.components[0]
    fh, fw = int(comp.fsize[0, 0, 0]), int(comp.fsize[0, 0, 1])
    masks = []
    for bucket in plan.buckets:
        m = np.zeros(
            (len(bucket.scale_indices), bucket.resp_h, bucket.resp_w), bool
        )
        for i, sidx in enumerate(bucket.scale_indices):
            m[i] = overlap_mask(
                (bucket.resp_h, bucket.resp_w),
                (fh, fw),
                plan.scales[sidx].box_scale,
                spec.padx,
                spec.pady,
                np.asarray(bbox, dtype=np.float64),
                overlap,
            )
        masks.append(m)
    return masks
