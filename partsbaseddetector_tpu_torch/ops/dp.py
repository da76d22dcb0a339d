"""Tree min-sum dynamic program + backtracking, batched over images and
scales.

Port of `partsbaseddetector_tpu/ops/dp.py` (`tree_min_sum` with its
unrolled level schedule, `backtrack_merged`, `backtrack`). Parts are
stored root-first (parentid[p] < p), so a leaves-to-root walk over tree
levels is a valid schedule. All parts of one level whose grids and step
agree run their 2-D distance transforms as one batched call. That
schedule, with every host-to-device copy of the DP (the parts, live
counts and consumer extents, the weights' slices), is `dp_plan`'s: it
follows from the shapes and the model alone, so the detector builds it
once per shape and replays the DP as a CUDA graph (ops/dp_graph.py).

Mixture combination follows passmsg (detect_fast.m:118-141):
msg_l = max_k (DT(score_k) + bias[l, k]), with a first-max-wins
where-chain over k, and pointers packed as (Ik << 24) | (Iy << 12) | Ix.
Root scoring adds the per-root-mixture bias and maxes over mixtures
(detect_fast.m:46-48). Invalid regions and padded mixtures carry -inf
and never win a max.

Backtracking mirrors detect_fast.m:144-177: the best root placements
(a stable top-k: equal scores keep the lower flat index first, as
jax.lax.top_k does) are walked root-to-leaves through the pointer
tables with gathers. Every constant a walk uploads (the buckets' flat
offsets and grids, the parts' table offsets, the box scales) is
`walk_plan`'s, built once per shape by the detector, so that its CUDA
graph replays the walks without a copy.

Every map carries a leading image axis B (the JAX package's vmap over
images, written out): responses (B, S, Hr, Wr, F), root maps
(B, S, Hr, Wr), one top-k per image. B stays its own axis through the
DP, so that slicing the scale axis ([:, :s]) never mixes images; it is
folded into the DT's batch of maps only at the DT call, where the
per-map parameters and live counts broadcast over it.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.model import DeviceComponent, PackedComponent
from .distance_transform import shift_distance_transform_2d_packed

NEG_INF = -math.inf


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, best first; ties keep index
    order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _levels(comp: PackedComponent) -> Dict[int, List[int]]:
    depth = np.zeros(comp.nparts, dtype=np.int64)
    for p in range(1, comp.nparts):
        depth[p] = depth[int(comp.parentid[p])] + 1
    levels: Dict[int, List[int]] = {}
    for p in range(1, comp.nparts):
        levels.setdefault(int(depth[p]), []).append(p)
    return levels


class DPGroup(NamedTuple):
    """One batched 2-D DT of the tree DP: the parts of one tree level
    whose octave offsets and step agree, with everything the DT call
    takes besides the scores, on the responses' device. A plan is a
    list of them in schedule order (leaves to root)."""

    parts: List[int]
    step: int
    hr_par: int  # the parent grid: the DT's output size
    wr_par: int
    pidx: torch.Tensor  # (G,) the parts
    shift_x: torch.Tensor  # (G, 1, 1, M)
    shift_y: torch.Tensor
    # (G, 1, 1, M, 4) in the DP dtype; None where the weights are trainable
    defw: Optional[torch.Tensor]
    # live counts (G, 1, S, M) and consumer extents (G, 1, S, M, W_child)
    # and (G, 1, S, 1, H_parent), int32; None where the weights are
    # trainable, and the extents also where a shift is not integral
    nv_y: Optional[torch.Tensor]
    nv_x: Optional[torch.Tensor]
    ov_y: Optional[torch.Tensor]
    ov_x: Optional[torch.Tensor]


def dp_plan(
    resps: List[torch.Tensor],
    comp: PackedComponent,
    dcomp: DeviceComponent,
    valid_extents: Tuple[List[np.ndarray], List[np.ndarray]],
    bucket_index: int = 0,
    buckets_per_octave: int = 1,
    trainable: bool = False,
) -> List[DPGroup]:
    """tree_min_sum's schedule for one component over a scale bucket,
    with every host-to-device copy the DP makes: it depends on the maps'
    shapes, dtype and device (not their values), the model and the valid
    extents, so a caller that runs one shape again and again builds it
    once (the detector keeps one per image size and batch, and its CUDA
    graph replays the DP without a copy). Arguments as tree_min_sum's;
    trainable leaves out the weights and the live counts."""
    bucket_of = lambda d: bucket_index - d * buckets_per_octave
    ds = comp.ds_total
    root_resp = resps[bucket_of(0)]
    s = root_resp.shape[1]
    dev = root_resp.device
    defw_all = None if trainable else dcomp.defw.to(root_resp.dtype)

    def grid_of(p: int) -> Tuple[int, int]:
        r = resps[bucket_of(int(ds[p]))]
        return r.shape[2], r.shape[3]

    def live_counts(p: int, par: int, w_child: int, hr_par: int):
        """Per-map live source counts (S, M) of the y pass and the x
        pass: the child's valid height (0 for a map with no valid
        column) and its valid width (0 when the parent has no valid
        row). Then the consumer extents of the JAX package's
        `_valid_counts`: the y pass's output rows that must be exact per
        child column, ovy (S, M, W_child) = the parent's valid height
        where the column is valid, else 0; the x pass's output columns
        per parent row, ovx (S, 1, H_parent) = the parent's valid width
        where the row is valid, else 0. The DT outputs beyond them meet
        -inf parent scores downstream."""
        fid = comp.filterid[p]
        vh_sm = valid_extents[0][bucket_of(int(ds[p]))][:s][:, fid]
        vw_sm = valid_extents[1][bucket_of(int(ds[p]))][:s][:, fid]
        par_fid = comp.filterid[par]
        vh_par, vw_par = (
            valid_extents[k][bucket_of(int(ds[par]))][:s][:, par_fid]
            .max(axis=1)
            for k in (0, 1)
        )  # (S,) each
        nvy = np.where(np.minimum(vw_sm, w_child) > 0, vh_sm, 0)
        nvx = np.where(
            np.minimum(vh_par, hr_par)[:, None] > 0, vw_sm, 0
        )
        ovy = np.where(
            np.arange(w_child)[None, None, :] < vw_sm[:, :, None],
            vh_par[:, None, None], 0,
        )
        ovx = np.where(
            np.arange(hr_par)[None, None, :] < vh_par[:, None, None],
            vw_par[:, None, None], 0,
        )
        return nvy, nvx, ovy, ovx

    plan: List[DPGroup] = []
    levels = _levels(comp)
    for lvl in sorted(levels, reverse=True):
        # stacked parts must share every DT shape parameter
        groups: Dict[tuple, List[int]] = {}
        for p in levels[lvl]:
            par = int(comp.parentid[p])
            key = (int(ds[p]), int(ds[par]), int(comp.step[p]))
            groups.setdefault(key, []).append(p)

        for (_, _, step), parts in groups.items():
            hr_par, wr_par = grid_of(int(comp.parentid[parts[0]]))
            pidx = torch.as_tensor(parts, device=dev)
            nv_y = nv_x = ov_y = ov_x = defw = None
            if not trainable:
                # (G, 1, S, M[, W]): broadcast over the images
                nvys, nvxs, ovys, ovxs = (
                    np.stack(c)[:, None] for c in zip(*(
                        live_counts(p, int(comp.parentid[p]), grid_of(p)[1], hr_par)
                        for p in parts
                    ))
                )
                nv_y = torch.as_tensor(nvys, device=dev)
                nv_x = torch.as_tensor(nvxs, device=dev)
                # the consumer extents also tell the DT that the shifts
                # are integral, which K5 needs: decided here, on the
                # host copy of the model
                shifts = np.stack([comp.shift_x[parts], comp.shift_y[parts]])
                if np.array_equal(shifts, np.round(shifts)):
                    ov_y, ov_x = (
                        torch.as_tensor(o, dtype=torch.int32, device=dev)
                        for o in (ovys, ovxs)
                    )
                defw = defw_all[pidx][:, None, None]
            plan.append(DPGroup(
                parts, step, hr_par, wr_par, pidx,
                dcomp.shift_x[pidx][:, None, None],
                dcomp.shift_y[pidx][:, None, None],
                defw, nv_y, nv_x, ov_y, ov_x,
            ))
    return plan


def tree_min_sum(
    resps: List[torch.Tensor],
    comp: PackedComponent,
    dcomp: DeviceComponent,
    valid_extents: Tuple[List[np.ndarray], List[np.ndarray]],
    bucket_index: int = 0,
    buckets_per_octave: int = 1,
    tensors=None,
    plan: Optional[List[DPGroup]] = None,
):
    """Min-sum message passing for one component over a scale bucket.

    resps: the per-bucket (B, S, Hr, Wr, F) response stacks, -inf
        outside valid extents; a part with accumulated octave offset d
        reads bucket bucket_index - d*buckets_per_octave.
    dcomp: the component's arrays on the responses' device.
    valid_extents: per-bucket ((S, F) vh, (S, F) vw) NumPy lists; they
        become per-map live counts for the DT kernel, which then skips
        the -inf padding, and the consumer extents that let the
        adaptive-window DT (PBD_DT_WINDOW=1) stop its scans early.
    tensors (optional): trainable (defw (P, M, 4), bias (P, M, M),
        root_bias (M,)) from `PackedComponent.tensors(params)`, replacing
        dcomp's constants. The DTs then carry K4's backward and get no
        live counts: training masks with -1e10, not -inf, so every masked
        cell is an ordinary source, as in the JAX package's XLA DT. The
        where-chains pass gradients to the selected branch only.
    plan (optional): dp_plan's schedule for these arguments, built here
        when not given; with it the DP copies nothing to the device.
    The weights are cast to the responses' dtype. With bf16 responses
    (the hybrid profile) the DTs widen their sources to f32 and return
    f32, so that a child's message, and every sum it enters, is f32 from
    there on: the dtypes of the JAX package's Pallas route on the chip.
    Returns (rootv (B, S, Hr, Wr), rooti int32, tables {p: packed int32
    pointers (B, S, L_parent, H_pargrid, W_pargrid)}).
    """
    bucket_of = lambda d: bucket_index - d * buckets_per_octave
    p_total, m_total = comp.filterid.shape
    ds = comp.ds_total
    if bucket_index < int(ds.max()) * buckets_per_octave:
        raise ValueError(
            "root bucket must be at least max octave offset octaves coarse"
        )
    root_resp = resps[bucket_of(0)]
    s = root_resp.shape[1]
    dev = root_resp.device
    for r in resps:
        if r.shape[2] >= 4096 or r.shape[3] >= 4096:
            raise ValueError("packed pointers use 12 bits/coordinate")
    trainable = tensors is not None
    if plan is None:
        plan = dp_plan(resps, comp, dcomp, valid_extents, bucket_index,
                       buckets_per_octave, trainable)
    # the model's weights in the responses' dtype, as the JAX package
    # casts them (bf16-rounded in the hybrid profile; the f32 DT then
    # widens them with its sources)
    dtype = root_resp.dtype
    defw_all, bias_all, root_bias = (
        t.to(dtype) for t in
        (tensors if trainable else (dcomp.defw, dcomp.bias, dcomp.root_bias))
    )

    def part_score(p: int) -> torch.Tensor:
        # align within-bucket scales: a finer bucket may hold more
        r = resps[bucket_of(int(ds[p]))][:, :s]
        return r.index_select(-1, dcomp.filterid[p]).permute(0, 1, 4, 2, 3)

    def combine(p: int, dt: torch.Tensor, ptr: torch.Tensor):
        """Mixture combine for one part, all parent mixtures l at once:
        a first-max-wins where-chain over child mixtures k.
        dt/ptr: (B, S, K, Hp, Wp) -> (msg, tbl): (B, S, L, Hp, Wp)."""
        b = bias_all[p][:, :, None, None]  # (L, K, 1, 1)
        best = dt[:, :, None, 0] + b[:, 0]
        ptrb = ptr[:, :, None, 0].expand_as(best)  # (0 << 24) | ptr
        for k in range(1, m_total):
            val = dt[:, :, None, k] + b[:, k]
            pred = val > best
            best = torch.where(pred, val, best)
            ptrb = torch.where(pred, (k << 24) | ptr[:, :, None, k], ptrb)
        return best, ptrb

    acc: Dict[int, torch.Tensor] = {}
    tables: Dict[int, torch.Tensor] = {}
    for g in plan:
        scores = []
        for p in g.parts:
            sc = part_score(p)
            if p in acc:
                sc = sc + acc.pop(p)
            scores.append(sc)
        score_g = torch.stack(scores)  # (G, B, S, M, H, W)
        dt_g, ptr_g = shift_distance_transform_2d_packed(
            score_g,
            defw_all[g.pidx][:, None, None] if g.defw is None else g.defw,
            g.shift_x,
            g.shift_y,
            dlen_x=g.wr_par,
            dlen_y=g.hr_par,
            step=g.step,
            valid_h=g.nv_y,
            valid_w=g.nv_x,
            differentiable=trainable,
            out_valid_h=g.ov_y,
            out_valid_w=g.ov_x,
        )
        for i, p in enumerate(g.parts):
            msg, tbl = combine(p, dt_g[i], ptr_g[i])
            tables[p] = tbl
            par = int(comp.parentid[p])
            acc[par] = msg if par not in acc else acc[par] + msg

    root = part_score(0)
    if 0 in acc:
        root = root + acc.pop(0)
    root = root + root_bias[:, None, None]
    rootv = root[:, :, 0]
    rooti = torch.zeros(rootv.shape, dtype=torch.int32, device=dev)
    for m in range(1, m_total):
        pred = root[:, :, m] > rootv
        rootv = torch.where(pred, root[:, :, m], rootv)
        rooti = torch.where(pred, m, rooti)
    return rootv, rooti, tables


def _unpack(ptr: torch.Tensor):
    """(Ik << 24) | (Iy << 12) | Ix -> (x, y, k) as int64 index tensors."""
    return (
        (ptr & 0xFFF).long(),
        ((ptr >> 12) & 0xFFF).long(),
        (ptr >> 24).long(),
    )


def _pad_top_k(vals, idx, k, max_det):
    """Pad (B, k) top-k rows to the static (B, max_det) budget."""
    if k < max_det:
        nb = vals.shape[0]
        vals = torch.cat([vals, vals.new_full((nb, max_det - k), NEG_INF)], 1)
        idx = torch.cat([idx, idx.new_zeros((nb, max_det - k))], 1)
    return vals, idx


class WalkPlan(NamedTuple):
    """Every device constant a backtrack walk reads besides the DP's maps
    and the model, on the maps' device: `walk_plan`'s. The merged walk's
    fields are None in a per-bucket walk's plan."""

    images: torch.Tensor  # (B,) int64: 0..B-1
    # (sum S_b,) every bucket's box scales, bucket-major, in the maps' dtype
    box_scales: torch.Tensor
    # the merged walk's, int64: per bucket (NB,) the flat root index
    # where it starts, its maps' height and width and its first row of
    # box_scales; 0..P-1; per tree level, root side first, the level's
    # parts' offsets (G, 1, 1) into the flat pointer table
    offsets: Optional[torch.Tensor] = None
    heights: Optional[torch.Tensor] = None
    widths: Optional[torch.Tensor] = None
    scale_offsets: Optional[torch.Tensor] = None
    parts: Optional[torch.Tensor] = None
    level_bases: Optional[List[torch.Tensor]] = None


def walk_plan(
    rootvs: List[torch.Tensor],
    box_scales_list: List[torch.Tensor],
    comp: Optional[PackedComponent] = None,
) -> WalkPlan:
    """The device constants of a walk over root maps of these shapes: they
    follow from the maps' shapes, dtype and device (not their values),
    the box scales and the tree, so a caller that walks one shape again
    and again builds them once (the detector keeps them with its tail's
    CUDA graph, which then replays the walks without a copy). rootvs:
    per bucket (B, S_b, H_b, W_b); box_scales_list: per bucket (S_b,);
    comp: backtrack_merged's component, for its flat offsets (without it
    the per-bucket walk's plan, from one bucket)."""
    dev = rootvs[0].device
    dtype = rootvs[0].dtype
    images = torch.arange(int(rootvs[0].shape[0]), device=dev)
    box_scales = torch.cat([b.to(dtype) for b in box_scales_list])
    if comp is None:
        return WalkPlan(images, box_scales)
    s_l = [int(rv.shape[1]) for rv in rootvs]
    h_l = [int(rv.shape[2]) for rv in rootvs]
    w_l = [int(rv.shape[3]) for rv in rootvs]
    ends = np.cumsum([s * h * w for s, h, w in zip(s_l, h_l, w_l)])
    per_part = comp.maxmix * int(ends[-1])
    levels = _levels(comp)
    return WalkPlan(
        images, box_scales,
        offsets=torch.as_tensor(np.concatenate([[0], ends[:-1]]).astype(np.int64),
                                device=dev),
        heights=torch.as_tensor(h_l, device=dev),
        widths=torch.as_tensor(w_l, device=dev),
        scale_offsets=torch.as_tensor(
            np.concatenate([[0], np.cumsum(s_l)[:-1]]).astype(np.int64), device=dev
        ),
        parts=torch.arange(comp.nparts, device=dev),
        level_bases=[
            torch.as_tensor(
                (np.asarray(levels[d], np.int64) - 1) * per_part, device=dev
            )[:, None, None]
            for d in sorted(levels)
        ],
    )


def backtrack_merged(
    rootvs: List[torch.Tensor],
    rootis: List[torch.Tensor],
    tables_list: List[Dict[int, torch.Tensor]],
    comp: PackedComponent,
    dcomp: DeviceComponent,
    box_scales_list: Optional[List[torch.Tensor]],
    box_off_x: int,
    box_off_y: int,
    thresh: float,
    max_det: int,
    plan: Optional[WalkPlan] = None,
):
    """Candidate extraction across all buckets of a component plus one
    level-batched tree walk: one top-k per image over the concatenated
    root maps, bucket/scale/coords recovered from static offsets, and
    one pointer-table gather per tree level. Requires all parts on the
    root grid (ds_total == 0). rootvs/rootis: per bucket (B, S, H, W);
    tables_list: per bucket {p: (B, S, L, H, W)}; box_scales_list: per
    bucket (S,), read only to build the plan.
    plan (optional): walk_plan(rootvs, box_scales_list, comp), built here
    when not given; with it the walk copies nothing to the device and
    never waits for it.

    Returns (boxes (B, max_det, P, 4) [x1, y1, x2, y2], scores
    (B, max_det), mixtures (B, max_det, P) int32, valid (B, max_det),
    coords (bucket, scale, xs (B, max_det, P), ys)).
    """
    if plan is None:
        plan = walk_plan(rootvs, box_scales_list, comp)
    nb = len(rootvs)
    p_total = comp.nparts
    m_total = comp.maxmix
    dtype = rootvs[0].dtype
    nimg = int(rootvs[0].shape[0])
    ends = np.cumsum([math.prod(rv.shape[1:]) for rv in rootvs])
    ntot = int(ends[-1])

    flat = torch.cat([rv.reshape(nimg, -1) for rv in rootvs], dim=1)
    k = min(max_det, ntot)
    vals, idx = _pad_top_k(*stable_top_k(flat, k), k, max_det)
    valid = vals >= thresh

    bid = torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    for b in range(1, nb):
        bid = bid + (idx >= int(ends[b - 1])).long()
    off_arr = plan.offsets[bid]
    hc = plan.heights[bid]
    wc = plan.widths[bid]
    local = idx - off_arr
    hw = hc * wc
    si = local // hw
    rem = local % hw
    yi = rem // wc
    xi = rem % wc
    mi = torch.gather(
        torch.cat([ri.reshape(nimg, -1) for ri in rootis], dim=1), 1, idx
    ).long()

    # one flat table buffer per image: part-major, then bucket-major
    # inside — entry (p, b, s, l, y, x) lives at
    # (p-1)*M*ntot + M*off[b] + ((s*M + l)*Hb + y)*Wb + x
    if p_total > 1:
        t_flat = torch.cat(
            [
                tables_list[b][p].reshape(nimg, -1)
                for p in range(1, p_total)
                for b in range(nb)
            ],
            dim=1,
        )
    t_off = m_total * off_arr
    img = plan.images[None, :, None]

    xs: List[torch.Tensor] = [None] * p_total
    ys: List[torch.Tensor] = [None] * p_total
    ms: List[torch.Tensor] = [None] * p_total
    xs[0], ys[0], ms[0] = xi, yi, mi
    levels = _levels(comp)
    for d, base in zip(sorted(levels), plan.level_bases):
        parts = levels[d]
        par_x = torch.stack([xs[int(comp.parentid[p])] for p in parts])
        par_y = torch.stack([ys[int(comp.parentid[p])] for p in parts])
        par_m = torch.stack([ms[int(comp.parentid[p])] for p in parts])
        idx_t = (
            base
            + t_off[None]
            + ((si[None] * m_total + par_m) * hc[None] + par_y) * wc[None]
            + par_x
        )  # (G, B, K)
        xg, yg, mg = _unpack(t_flat[img, idx_t])
        for g, p in enumerate(parts):
            xs[p], ys[p], ms[p] = xg[g], yg[g], mg[g]

    root_scale = plan.box_scales[plan.scale_offsets[bid] + si]

    xs_t = torch.stack(xs, dim=-1)  # (B, K, P)
    ys_t = torch.stack(ys, dim=-1)
    ms_t = torch.stack(ms, dim=-1)
    sz = dcomp.fsize[plan.parts, ms_t]  # (B, K, P, 2)
    sc_b = root_scale[..., None]  # ds_total == 0: one grid for all parts
    x1 = (xs_t.to(dtype) + box_off_x) * sc_b
    y1 = (ys_t.to(dtype) + box_off_y) * sc_b
    x2 = x1 + sz[..., 1].to(dtype) * sc_b - 1
    y2 = y1 + sz[..., 0].to(dtype) * sc_b - 1
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    mixtures = ms_t.to(torch.int32)
    coords = (
        bid.to(torch.int32),
        si.to(torch.int32),
        xs_t.to(torch.int32),
        ys_t.to(torch.int32),
    )
    return boxes, vals, mixtures, valid, coords


def backtrack(
    rootv: torch.Tensor,
    rooti: torch.Tensor,
    tables: Dict[int, torch.Tensor],
    comp: PackedComponent,
    dcomp: DeviceComponent,
    box_scales: Optional[torch.Tensor],
    box_off_x: int,
    box_off_y: int,
    thresh: float,
    max_det: int,
    plan: Optional[WalkPlan] = None,
):
    """Per-bucket candidate extraction and tree walk; parts may sit on
    octave-finer grids (ds_total > 0). Box geometry follows
    detect_fast.m:170-175 (0-based): x1 = (x - padx) * scale,
    x2 = x1 + sizx*scale - 1. rootv/rooti (B, S, Hr, Wr), tables
    {p: (B, S, L, H, W)}; box_scales (S,), read only to build the plan.
    plan (optional): walk_plan([rootv], [box_scales]), built here when
    not given. Same return contract as backtrack_merged, with coords
    (scale, xs, ys)."""
    if plan is None:
        plan = walk_plan([rootv], [box_scales])
    nimg, s, hr, wr = rootv.shape
    p_total = comp.nparts
    dtype = rootv.dtype
    flat = rootv.reshape(nimg, -1)
    k = min(max_det, flat.shape[1])
    vals, idx = _pad_top_k(*stable_top_k(flat, k), k, max_det)
    valid = vals >= thresh

    si = idx // (hr * wr)
    rem = idx % (hr * wr)
    yi = rem // wr
    xi = rem % wr
    mi = torch.gather(rooti.reshape(nimg, -1), 1, idx).long()
    img = plan.images[:, None]

    xs: List[torch.Tensor] = [None] * p_total
    ys: List[torch.Tensor] = [None] * p_total
    ms: List[torch.Tensor] = [None] * p_total
    xs[0], ys[0], ms[0] = xi, yi, mi
    for p in range(1, p_total):
        par = int(comp.parentid[p])
        xs[p], ys[p], ms[p] = _unpack(
            tables[p][img, si, ms[par], ys[par], xs[par]]
        )

    root_scale = plan.box_scales[si]
    ds = comp.ds_total
    boxes = []
    for p in range(p_total):
        # a part d octaves below the root lives on a 2^d finer grid
        scale = root_scale / float(1 << int(ds[p]))
        sz = dcomp.fsize[p][ms[p]]  # (B, max_det, 2) = (fh, fw)
        x1 = (xs[p].to(dtype) + box_off_x) * scale
        y1 = (ys[p].to(dtype) + box_off_y) * scale
        x2 = x1 + sz[..., 1].to(dtype) * scale - 1
        y2 = y1 + sz[..., 0].to(dtype) * scale - 1
        boxes.append(torch.stack([x1, y1, x2, y2], dim=-1))
    boxes = torch.stack(boxes, dim=2)  # (B, max_det, P, 4)
    mixtures = torch.stack(ms, dim=2).to(torch.int32)
    coords = (
        si.to(torch.int32),
        torch.stack(xs, dim=2).to(torch.int32),
        torch.stack(ys, dim=2).to(torch.int32),
    )
    return boxes, vals, mixtures, valid, coords
