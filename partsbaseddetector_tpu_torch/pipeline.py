"""Forward pipeline: image -> root score maps + DP pointer tables.

Port of `partsbaseddetector_tpu/pipeline.py` (`make_plan`,
`fourier_spectra_args`, `depth_response_masks`, `root_scores`,
`max_root_score`, `build_root_masks`): HOG pyramid -> part-filter
responses -> valid-extent masking (and optional response gates) ->
tree min-sum DP for every (bucket, component) pair.

  - inference (params=None): the responses from the K2 kernel on the
    card (spatial engine) or from cuFFT transforms around batched
    matrix products (Fourier engine, with the filters' spectra cached
    per image size), -inf masking, the DT kernels (K1, or K5 under
    PBD_DT_WINDOW=1) without a backward;
  - training (params = {'filters', 'defs', 'biases'} torch tensors): the
    plain conv (`ops/conv.py::filter_responses`) under autograd, -1e10
    masking, and the DTs with K4's backward, so the root scores are
    differentiable in every pool. The HOG pyramid runs without a graph:
    the image gets no gradient. The Fourier engine is not ported for
    training.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from . import depth as depth_mod
from .models.model import DeviceModel, PackedModel
from .ops.conv import fft_filter_spectra, filter_responses, filter_responses_fft
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
    """Root scores for one (bucket, component) pair; a batch of images
    adds a leading image axis to every tensor."""

    bucket_index: int
    component: int
    rootv: torch.Tensor  # ([B,] S, Hr, Wr)
    rooti: torch.Tensor  # ([B,] S, Hr, Wr) int32
    tables: Dict[int, torch.Tensor]  # ([B,] S, L, H, W) int32


def make_plan(
    packed: PackedModel, imsize: Tuple[int, int], buckets_per_octave: int = 1
) -> PyramidPlan:
    fh_max, fw_max = packed.filters.shape[1], packed.filters.shape[2]
    return build_plan(
        imsize, packed.spec, fh_max, fw_max, buckets_per_octave
    )


def fourier_spectra_args(
    packed: PackedModel, plan: PyramidPlan
) -> List[np.ndarray]:
    """Host conjugate filter spectra, one (2, feat_h, wf, C, F) f32
    array per bucket, for root_scores(fft_spectra=...) once on the
    device (the detector uploads them once per image size)."""
    return [
        fft_filter_spectra(packed.filters, b.feat_h, b.feat_w)
        for b in plan.buckets
    ]


def depth_response_masks(
    depth: torch.Tensor, plan: PyramidPlan, spec, gate, dtype=torch.float32
) -> List[torch.Tensor]:
    """Per-bucket plausible-depth response gates, (S_b, Hr, Wr) bool on
    depth's device: True where the sampled depth d is within
    gate.tolerance * z of the scale's expected depth
    z = gate.fx * gate.object_width_m / box_scale, or unknown (<= 0 or
    not finite). depth: (H, W) f32 metres. The sample indices are the
    host's `depth.gate_sample_indices`, so the mask equals the host
    predictor `depth.depth_level_mask` on every scale's grid; d and z
    are compared in `dtype` (the detector's: bf16 in the hybrid
    profile, as in the JAX package)."""
    h_im, w_im = plan.imsize
    dh, dw = depth.shape
    off_x = -1 if spec.border == "cpp" else -spec.padx
    off_y = -1 if spec.border == "cpp" else -spec.pady
    dev = depth.device
    depth = depth.to(dtype)
    masks: List[torch.Tensor] = []
    for bucket in plan.buckets:
        boxes = [plan.scales[s].box_scale for s in bucket.scale_indices]
        iy = np.stack([
            depth_mod.gate_sample_indices(bucket.resp_h, off_y, bs, h_im, dh)
            for bs in boxes
        ])  # (S, Hr)
        ix = np.stack([
            depth_mod.gate_sample_indices(bucket.resp_w, off_x, bs, w_im, dw)
            for bs in boxes
        ])  # (S, Wr)
        z = torch.as_tensor(
            [gate.fx * gate.object_width_m / bs for bs in boxes],
            dtype=dtype, device=dev,
        )[:, None, None]
        iy_t = torch.as_tensor(iy, dtype=torch.long, device=dev)
        ix_t = torch.as_tensor(ix, dtype=torch.long, device=dev)
        sampled = depth[iy_t[:, :, None], ix_t[:, None, :]]
        masks.append(
            ((sampled - z).abs() <= gate.tolerance * z)
            | (sampled <= 0)
            | ~torch.isfinite(sampled)
        )
    return masks


def root_scores(
    im: torch.Tensor,
    packed: PackedModel,
    dmodel: DeviceModel,
    plan: PyramidPlan,
    params: Optional[dict] = None,
    engine: str = "spatial",
    with_tables: bool = True,
    remat: bool = False,
    response_masks: Optional[List[torch.Tensor]] = None,
    fft_spectra: Optional[List[torch.Tensor]] = None,
    dtype=torch.float32,
    collect_responses: Optional[List[torch.Tensor]] = None,
) -> List[BucketScores]:
    """Run HOG pyramid -> responses -> tree DP for every (bucket,
    component). im: one (H, W, 3) frame or a (B, H, W, 3) batch on
    dmodel's device, any real dtype (cast to f32 here, so a uint8 frame
    computes exactly as its f32 copy). A batch runs as one
    program with a leading image axis on every map (the JAX package's vmap over
    images), and each image's scores equal its single-frame scores; a
    single frame's BucketScores carry no image axis.
    params (optional): trainable pools on the same device (see the
    module docstring). with_tables=False drops the pointer tables.
    remat=True (with params, without tables) recomputes the DP block in
    the backward pass instead of keeping its intermediates
    (`torch.utils.checkpoint`, the JAX package's `jax.checkpoint`).
    engine: "spatial" or "fourier" (inference only). fft_spectra
    (optional, Fourier): fourier_spectra_args' arrays as tensors on the
    device; without them they are computed (and memoized) on the host
    and uploaded here. response_masks (optional): one (S_b, Hr, Wr)
    bool tensor per bucket (depth_response_masks), applied to every
    filter and image; False cells take the masking value, as outside the valid
    extents.
    dtype: the DP's dtype. HOG and the conv always run in f32 (the K2
    kernel); the responses are cast to dtype before the masking: float32,
    or bfloat16 for the hybrid profile, whose DTs widen their sources to
    f32 (ops/distance_transform.py). collect_responses (optional): a
    list the raw per-bucket (B, S_b, Hr, Wr, F) f32 responses, before
    the cast and the masking, are appended to, for
    ops/rescore.py::rescore_from_responses. A single frame's carry the
    image axis too."""
    if engine not in ("spatial", "fourier"):
        raise ValueError(f"unknown conv engine: {engine}")
    if engine == "fourier" and params is not None:
        raise NotImplementedError(
            "training with the Fourier engine is not ported yet"
        )
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"root_scores: DP dtype {dtype}; the ported profiles are float32 "
            "and bfloat16 over a float32 conv"
        )
    if params is not None and dtype != torch.float32:
        raise NotImplementedError("training runs in float32 only")
    spec = packed.spec
    single = im.dim() == 3
    if single:
        im = im[None]
    nimg = im.shape[0]
    with torch.no_grad():
        feats = build_pyramid_features(im.to(torch.float32), plan, spec)
    if engine == "fourier" and fft_spectra is None:
        fft_spectra = [
            torch.as_tensor(sp, device=im.device)
            for sp in fourier_spectra_args(packed, plan)
        ]

    neg = -math.inf if params is None else -1e10
    resps: List[torch.Tensor] = []
    vhs: List[np.ndarray] = []
    vws: List[np.ndarray] = []
    for b, bucket in enumerate(plan.buckets):
        # the conv takes the B*S_b maps image-major; the Fourier engine
        # keeps the image axis and broadcasts its spectra over it
        feat = feats[b].reshape(-1, *feats[b].shape[2:])
        if params is not None:
            resp = filter_responses(feat, params["filters"])
        elif engine == "fourier":
            resp = filter_responses_fft(feats[b], dmodel.filters, fft_spectra[b])
        else:
            resp = filter_responses_infer(feat, dmodel.filters)
        resp = resp.reshape(nimg, -1, *resp.shape[-3:])
        if collect_responses is not None:
            # real placements never index masked cells, and the re-score
            # gathers scalars from these
            collect_responses.append(resp)
        resp = resp.to(dtype)
        vh, vw = response_valid_extents(
            plan, bucket, packed.filter_sizes, spec.border
        )
        resp = mask_responses(resp, vh, vw, neg)
        if response_masks is not None:
            resp = torch.where(
                response_masks[b][..., None], resp,
                torch.full((), neg, dtype=dtype, device=resp.device),
            )
        resps.append(resp)
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
            if single:
                rootv, rooti = rootv[0], rooti[0]
                tables = {p: t[0] for p, t in tables.items()}
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
