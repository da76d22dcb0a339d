"""fp32 re-scoring of backtracked placements: the hybrid serving stage.

Port of `partsbaseddetector_tpu/ops/rescore.py`. The bf16 profile runs
the tree DP on bf16 responses; bf16's 8-bit mantissa flips near-tie
placements and rounds scores. Given the top-k candidates' placements
(bucket, scale, per-part grid coords and mixtures from the backtrack
pointer walk), this stage recomputes each candidate's full score in f32

    score = resp_root + root_bias
          + sum_child [ resp_child + bias[l_par, k] - defcost(dx, dy) ]

and rebuilds its part boxes in f32; the detector then re-sorts by that
score. It is the score-reconstruction identity of
matlab/detection/detect.m:141-146 run as a serving stage: on an f32
pipeline it reproduces the DP's scores. defcost follows shiftdt.cc:65-78
(positive costs, output grid q = shift + i*step); biases follow
detect_fast.m:118-141 and 46-48.

`rescore_from_responses` (the serving path) gathers one f32 response
scalar per (candidate, part) from the raw responses `root_scores`
collected; `rescore_placements` (the reference formulation) gathers a
feature patch per part and takes its dot product with the filter.

Every candidate tensor carries a leading image axis, as the rest of the
port: comps/bid/si (B, K), xs/ys/ms (B, K, Pm), per-bucket maps
(B, S_b, H_b, W_b, ...). `RescoreTables` and `build_rescore_tables` are a
NumPy copy of the JAX package's; `tables_on` puts them on a device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..models.model import PackedModel
from .pyramid import PyramidPlan


class RescoreTables(NamedTuple):
    """Static per-model tables, components stacked and padded to a
    common (P_max, M_max), so that one gather serves every candidate
    whatever its component. Padded slots hold finite benign values (0
    biases, zero deformation weights, filter 0): padded parts are killed
    by partmask, and padded mixtures are never selected by a valid
    candidate (their -inf bias cannot win a max in the DP). NumPy arrays
    from build_rescore_tables, tensors after tables_on."""

    parent: np.ndarray  # (NC, Pm) int32
    partmask: np.ndarray  # (NC, Pm) float32, 1.0 for real parts
    filterid: np.ndarray  # (NC, Pm, Mm) int32
    defw: np.ndarray  # (NC, Pm, Mm, 4) float32 positive costs
    shift_x: np.ndarray  # (NC, Pm, Mm) float32
    shift_y: np.ndarray  # (NC, Pm, Mm) float32
    step: np.ndarray  # (NC, Pm) float32
    bias: np.ndarray  # (NC, Pm, Mm, Mm) float32 [l_parent, k_child]
    root_bias: np.ndarray  # (NC, Mm) float32
    fsize: np.ndarray  # (NC, Pm, Mm, 2) float32 true (fh, fw) in cells
    ds: np.ndarray  # (NC, Pm) int32 accumulated octave offsets
    # from the pyramid plan
    bsc_flat: np.ndarray  # (sum S_b,) float32 box scales, bucket-major
    soff: np.ndarray  # (NB,) int32 bucket offsets into bsc_flat
    bpo: int  # buckets per octave


def build_rescore_tables(
    packed: PackedModel, plan: PyramidPlan, buckets_per_octave: int = 1
) -> RescoreTables:
    comps = packed.components
    nc = len(comps)
    pm = max(c.nparts for c in comps)
    mm = max(c.maxmix for c in comps)

    parent = np.zeros((nc, pm), np.int32)
    partmask = np.zeros((nc, pm), np.float32)
    filterid = np.zeros((nc, pm, mm), np.int32)
    defw = np.zeros((nc, pm, mm, 4), np.float32)
    shift_x = np.zeros((nc, pm, mm), np.float32)
    shift_y = np.zeros((nc, pm, mm), np.float32)
    step = np.ones((nc, pm), np.float32)
    bias = np.zeros((nc, pm, mm, mm), np.float32)
    root_bias = np.zeros((nc, mm), np.float32)
    fsize = np.ones((nc, pm, mm, 2), np.float32)
    ds = np.zeros((nc, pm), np.int32)
    for c, comp in enumerate(comps):
        p, m = comp.nparts, comp.maxmix
        parent[c, :p] = comp.parentid
        partmask[c, :p] = 1.0
        filterid[c, :p, :m] = comp.filterid
        defw[c, :p, :m] = comp.defw
        shift_x[c, :p, :m] = comp.shift_x
        shift_y[c, :p, :m] = comp.shift_y
        step[c, :p] = comp.step
        bias[c, :p, :m, :m] = np.where(np.isfinite(comp.bias), comp.bias, 0.0)
        root_bias[c, :m] = np.where(
            np.isfinite(comp.root_bias), comp.root_bias, 0.0
        )
        fsize[c, :p, :m] = comp.fsize
        if comp.ds_total is not None:
            ds[c, :p] = comp.ds_total

    s_l = [len(b.scale_indices) for b in plan.buckets]
    soff = np.concatenate([[0], np.cumsum(s_l)[:-1]]).astype(np.int32)
    bsc_flat = np.asarray(
        [plan.scales[s].box_scale for b in plan.buckets for s in b.scale_indices],
        np.float32,
    )
    return RescoreTables(
        parent=parent, partmask=partmask, filterid=filterid, defw=defw,
        shift_x=shift_x, shift_y=shift_y, step=step, bias=bias,
        root_bias=root_bias, fsize=fsize, ds=ds, bsc_flat=bsc_flat,
        soff=soff, bpo=int(buckets_per_octave),
    )


def tables_on(tables: RescoreTables, device) -> RescoreTables:
    """The tables as tensors on `device`: float arrays as float32, index
    arrays as int64."""
    def conv(x):
        if not isinstance(x, np.ndarray):
            return x
        dtype = torch.int64 if x.dtype.kind in "iu" else torch.float32
        return torch.as_tensor(x, dtype=dtype, device=device)

    return RescoreTables(*(conv(x) for x in tables))


def _geometry_terms(t: RescoreTables, cidx, bid, si, xs, ys, ms,
                    box_off_x: int, box_off_y: int):
    """The f32 geometry of placements: per-child deformation and pairwise
    bias terms, the root bias, the part boxes, and the gather metadata
    both appearance paths need. cidx/bid/si (B, K), xs/ys/ms (B, K, Pm)
    int64; t on their device (tables_on).

    Returns (geom (B, K, Pm) f32 = bias - defcost for children, 0 for the
    root slot; rootb (B, K); boxes (B, K, Pm, 4); pmask (B, K, Pm); fid
    (B, K, Pm); bb (B, K, Pm), the octaves below the root's bucket times
    buckets per octave)."""
    f32 = torch.float32
    pm = xs.shape[-1]
    prng = torch.arange(pm, device=xs.device)
    c3 = cidx[..., None]
    par = t.parent[cidx]  # (B, K, Pm)
    pmask = t.partmask[cidx]
    fid = t.filterid[c3, prng, ms]
    ds_p = t.ds[cidx]

    # deformation + pairwise bias terms (children only)
    pxs = torch.gather(xs, -1, par).to(f32)
    pys = torch.gather(ys, -1, par).to(f32)
    pms = torch.gather(ms, -1, par)  # the parent's mixture l
    shx = t.shift_x[c3, prng, ms]
    shy = t.shift_y[c3, prng, ms]
    stp = t.step[cidx]
    dx = shx + pxs * stp - xs.to(f32)
    dy = shy + pys * stp - ys.to(f32)
    dw = t.defw[c3, prng, ms]  # (B, K, Pm, 4)
    defcost = (
        dw[..., 0] * dx * dx
        + dw[..., 1] * dx
        + dw[..., 2] * dy * dy
        + dw[..., 3] * dy
    )
    bias_pk = t.bias[c3, prng, pms, ms]  # bias[c, p, l_parent, k_child]
    rootb = t.root_bias[cidx, ms[..., 0]]
    geom = torch.where(prng == 0, 0.0, bias_pk - defcost)

    # f32 part boxes (detect_fast.m:170-175)
    root_scale = t.bsc_flat[t.soff[bid] + si]  # (B, K)
    scale = root_scale[..., None] / torch.exp2(ds_p.to(f32))
    fsz = t.fsize[c3, prng, ms]  # (B, K, Pm, 2)
    x1 = (xs.to(f32) + box_off_x) * scale
    y1 = (ys.to(f32) + box_off_y) * scale
    x2 = x1 + fsz[..., 1] * scale - 1
    y2 = y1 + fsz[..., 0] * scale - 1
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    # padded parts repeat the root box, as the detector pads them
    boxes = torch.where((pmask > 0)[..., None], boxes, boxes[..., :1, :])
    return geom, rootb, boxes, pmask, fid, ds_p * t.bpo


def _flat_maps(maps: List[torch.Tensor]):
    """Per-bucket (B, S_b, H_b, W_b, X) maps -> (flat (B, N) f32, per-bucket
    offsets, heights and widths as int64 tensors)."""
    nimg = maps[0].shape[0]
    dev = maps[0].device
    flat = torch.cat([m.to(torch.float32).reshape(nimg, -1) for m in maps], dim=1)
    sizes = [m[0].numel() for m in maps]
    off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    as_t = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=dev)
    return (flat, as_t(off), as_t([m.shape[2] for m in maps]),
            as_t([m.shape[3] for m in maps]))


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat[b, idx[b, ...]] with indices clamped into range (jnp.take's
    mode="clip")."""
    nimg = flat.shape[0]
    idx = idx.clamp(0, flat.shape[1] - 1)
    return torch.gather(flat, 1, idx.reshape(nimg, -1)).reshape(idx.shape)


def rescore_placements(
    feats32: List[torch.Tensor],
    filters32: torch.Tensor,
    tables: RescoreTables,
    comps: torch.Tensor,
    bid: torch.Tensor,
    si: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    ms: torch.Tensor,
    box_off_x: int,
    box_off_y: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recompute scores and part boxes in f32 from FEATURES, the literal
    w . phi(placement) identity (detect.m:141-146): one patch gather and
    dot product per part. The reference formulation; serving uses
    rescore_from_responses.

    feats32: per-bucket (B, S_b, H_b, W_b, C) f32 HOG stacks of the plan
    the pipeline used; filters32: (F, bh, bw, C) the zero-padded bank;
    tables on the candidates' device. comps/bid/si (B, K), xs/ys/ms
    (B, K, Pm). Returns (scores (B, K) f32, boxes (B, K, Pm, 4) f32).
    Padded candidates give finite garbage: callers mask by validity."""
    _, bh, bw, ch = filters32.shape
    nb = len(feats32)
    flat, off, h_l, w_l = _flat_maps(feats32)
    cidx, bid, si, xs, ys, ms = (t.long() for t in (comps, bid, si, xs, ys, ms))
    geom, rootb, boxes, pmask, fid, ds_b = _geometry_terms(
        tables, cidx, bid, si, xs, ys, ms, box_off_x, box_off_y
    )
    bb = (bid[..., None] - ds_b).clamp(0, nb - 1)  # (B, K, Pm)
    hb, wb = h_l[bb], w_l[bb]
    base = off[bb] + ((si[..., None] * hb + ys) * wb + xs) * ch
    dev = flat.device
    iy = torch.arange(bh, device=dev)[:, None, None]
    ix = torch.arange(bw, device=dev)[None, :, None]
    ic = torch.arange(ch, device=dev)[None, None, :]
    idx = base[..., None, None, None] + (iy * wb[..., None, None, None] + ix) * ch + ic
    patches = _take(flat, idx)  # (B, K, Pm, bh, bw, C)
    app = torch.einsum("...ijc,...ijc->...", patches, filters32[fid])
    scores = ((app + geom) * pmask).sum(dim=-1) + rootb
    return scores, boxes


def rescore_from_responses(
    resps32: List[torch.Tensor],
    tables: RescoreTables,
    comps: torch.Tensor,
    bid: torch.Tensor,
    si: torch.Tensor,
    xs: torch.Tensor,
    ys: torch.Tensor,
    ms: torch.Tensor,
    box_off_x: int,
    box_off_y: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recompute scores and part boxes in f32 from the pipeline's own f32
    filter RESPONSES (the hybrid serving path).

    resps32: per-bucket (B, S_b, Hr, Wr, F) f32 responses, the raw
    (unmasked) conv outputs root_scores(collect_responses=) gathered.
    Part p's appearance term is resp32[bucket][si, y, x, filterid], so
    the re-score is B*K*Pm scalar gathers plus the f32 geometry; with the
    conv in f32 it equals the f32 pipeline's score for the same placement
    up to the order of the sum. comps/bid/si (B, K), xs/ys/ms (B, K, Pm);
    tables on their device. Returns (scores (B, K) f32, boxes
    (B, K, Pm, 4) f32). Padded candidates give finite garbage."""
    nb = len(resps32)
    nf = resps32[0].shape[-1]
    flat, off, h_l, w_l = _flat_maps(resps32)
    cidx, bid, si, xs, ys, ms = (t.long() for t in (comps, bid, si, xs, ys, ms))
    geom, rootb, boxes, pmask, fid, ds_b = _geometry_terms(
        tables, cidx, bid, si, xs, ys, ms, box_off_x, box_off_y
    )
    bb = (bid[..., None] - ds_b).clamp(0, nb - 1)  # (B, K, Pm)
    hb, wb = h_l[bb], w_l[bb]
    idx = off[bb] + ((si[..., None] * hb + ys) * wb + xs) * nf + fid
    app = _take(flat, idx)  # (B, K, Pm)
    scores = ((app + geom) * pmask).sum(dim=-1) + rootb
    return scores, boxes
