"""Tree min-sum dynamic program + backtracking, batched over images and
scales.

Port of `partsbaseddetector_tpu/ops/dp.py` (`tree_min_sum` with its
unrolled level schedule, `backtrack_merged`, `backtrack`). Parts are
stored root-first (parentid[p] < p), so a leaves-to-root walk over tree
levels is a valid schedule. All parts of one level whose grids and step
agree run their 2-D distance transforms as one batched call.

Mixture combination follows passmsg (detect_fast.m:118-141):
msg_l = max_k (DT(score_k) + bias[l, k]), with a first-max-wins
where-chain over k, and pointers packed as (Ik << 24) | (Iy << 12) | Ix.
Root scoring adds the per-root-mixture bias and maxes over mixtures
(detect_fast.m:46-48). Invalid regions and padded mixtures carry -inf
and never win a max.

Backtracking mirrors detect_fast.m:144-177: the best root placements
(a stable top-k: equal scores keep the lower flat index first, as
jax.lax.top_k does) are walked root-to-leaves through the pointer
tables with gathers.

Every map carries a leading image axis B (the JAX package's vmap over
images, written out): responses (B, S, Hr, Wr, F), root maps
(B, S, Hr, Wr), one top-k per image. B stays its own axis through the
DP, so that slicing the scale axis ([:, :s]) never mixes images; it is
folded into the DT's batch of maps only at the DT call, where the
per-map parameters and live counts broadcast over it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

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


def tree_min_sum(
    resps: List[torch.Tensor],
    comp: PackedComponent,
    dcomp: DeviceComponent,
    valid_extents: Tuple[List[np.ndarray], List[np.ndarray]],
    bucket_index: int = 0,
    buckets_per_octave: int = 1,
    tensors=None,
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

    levels = _levels(comp)
    acc: Dict[int, torch.Tensor] = {}
    tables: Dict[int, torch.Tensor] = {}
    for lvl in sorted(levels, reverse=True):
        # stacked parts must share every DT shape parameter
        groups: Dict[tuple, List[int]] = {}
        for p in levels[lvl]:
            par = int(comp.parentid[p])
            key = (int(ds[p]), int(ds[par]), int(comp.step[p]))
            groups.setdefault(key, []).append(p)

        for (_, _, step), parts in groups.items():
            hr_par, wr_par = grid_of(int(comp.parentid[parts[0]]))
            scores, counts = [], []
            for p in parts:
                sc = part_score(p)
                if p in acc:
                    sc = sc + acc.pop(p)
                scores.append(sc)
                if not trainable:
                    counts.append(live_counts(
                        p, int(comp.parentid[p]), sc.shape[-1], hr_par
                    ))
            score_g = torch.stack(scores)  # (G, B, S, M, H, W)
            pidx = torch.as_tensor(parts, device=dev)
            nv_y = nv_x = ov_y = ov_x = None
            if not trainable:
                # (G, 1, S, M[, W]): broadcast over the images
                nvys, nvxs, ovys, ovxs = (
                    np.stack(c)[:, None] for c in zip(*counts)
                )
                nv_y = torch.as_tensor(nvys, device=dev)
                nv_x = torch.as_tensor(nvxs, device=dev)
                # the consumer extents also tell the DT that the shifts
                # are integral, which K5 needs: decided here, on the
                # host copy of the model
                shifts = np.stack([comp.shift_x[parts], comp.shift_y[parts]])
                if np.array_equal(shifts, np.round(shifts)):
                    ov_y, ov_x = ovys, ovxs
            dt_g, ptr_g = shift_distance_transform_2d_packed(
                score_g,
                defw_all[pidx][:, None, None],  # (G, 1, 1, M, 4)
                dcomp.shift_x[pidx][:, None, None],  # (G, 1, 1, M)
                dcomp.shift_y[pidx][:, None, None],
                dlen_x=wr_par,
                dlen_y=hr_par,
                step=step,
                valid_h=nv_y,
                valid_w=nv_x,
                differentiable=trainable,
                out_valid_h=ov_y,
                out_valid_w=ov_x,
            )
            for i, p in enumerate(parts):
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


def backtrack_merged(
    rootvs: List[torch.Tensor],
    rootis: List[torch.Tensor],
    tables_list: List[Dict[int, torch.Tensor]],
    comp: PackedComponent,
    dcomp: DeviceComponent,
    box_scales_list: List[torch.Tensor],
    box_off_x: int,
    box_off_y: int,
    thresh: float,
    max_det: int,
):
    """Candidate extraction across all buckets of a component plus one
    level-batched tree walk: one top-k per image over the concatenated
    root maps, bucket/scale/coords recovered from static offsets, and
    one pointer-table gather per tree level. Requires all parts on the
    root grid (ds_total == 0). rootvs/rootis: per bucket (B, S, H, W);
    tables_list: per bucket {p: (B, S, L, H, W)}.

    Returns (boxes (B, max_det, P, 4) [x1, y1, x2, y2], scores
    (B, max_det), mixtures (B, max_det, P) int32, valid (B, max_det),
    coords (bucket, scale, xs (B, max_det, P), ys)).
    """
    nb = len(rootvs)
    p_total = comp.nparts
    m_total = comp.maxmix
    dev = rootvs[0].device
    dtype = rootvs[0].dtype
    nimg = int(rootvs[0].shape[0])
    s_l = [int(rv.shape[1]) for rv in rootvs]
    h_l = [int(rv.shape[2]) for rv in rootvs]
    w_l = [int(rv.shape[3]) for rv in rootvs]
    n_l = [s * h * w for s, h, w in zip(s_l, h_l, w_l)]
    off = np.concatenate([[0], np.cumsum(n_l)]).astype(np.int64)
    ntot = int(off[-1])

    flat = torch.cat([rv.reshape(nimg, -1) for rv in rootvs], dim=1)
    k = min(max_det, ntot)
    vals, idx = _pad_top_k(*stable_top_k(flat, k), k, max_det)
    valid = vals >= thresh

    off_t = torch.as_tensor(off, device=dev)
    bid = torch.zeros(idx.shape, dtype=torch.int64, device=dev)
    for b in range(1, nb):
        bid = bid + (idx >= int(off[b])).long()
    off_arr = off_t[:nb][bid]
    hc = torch.as_tensor(h_l, device=dev)[bid]
    wc = torch.as_tensor(w_l, device=dev)[bid]
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
    per_part = m_total * ntot
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
    img = torch.arange(nimg, device=dev)[None, :, None]

    xs: List[torch.Tensor] = [None] * p_total
    ys: List[torch.Tensor] = [None] * p_total
    ms: List[torch.Tensor] = [None] * p_total
    xs[0], ys[0], ms[0] = xi, yi, mi
    levels = _levels(comp)
    for d in sorted(levels):
        parts = levels[d]
        base = torch.as_tensor(
            (np.asarray(parts, np.int64) - 1) * per_part, device=dev
        )[:, None, None]
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

    soff = np.concatenate([[0], np.cumsum(s_l)]).astype(np.int64)
    bsc_flat = torch.cat([b_.to(dtype) for b_ in box_scales_list])
    root_scale = bsc_flat[torch.as_tensor(soff[:nb], device=dev)[bid] + si]

    xs_t = torch.stack(xs, dim=-1)  # (B, K, P)
    ys_t = torch.stack(ys, dim=-1)
    ms_t = torch.stack(ms, dim=-1)
    sz = dcomp.fsize[torch.arange(p_total, device=dev), ms_t]  # (B, K, P, 2)
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
    box_scales: torch.Tensor,
    box_off_x: int,
    box_off_y: int,
    thresh: float,
    max_det: int,
):
    """Per-bucket candidate extraction and tree walk; parts may sit on
    octave-finer grids (ds_total > 0). Box geometry follows
    detect_fast.m:170-175 (0-based): x1 = (x - padx) * scale,
    x2 = x1 + sizx*scale - 1. rootv/rooti (B, S, Hr, Wr), tables
    {p: (B, S, L, H, W)}. Same return contract as backtrack_merged, with
    coords (scale, xs, ys)."""
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
    img = torch.arange(nimg, device=rootv.device)[:, None]

    xs: List[torch.Tensor] = [None] * p_total
    ys: List[torch.Tensor] = [None] * p_total
    ms: List[torch.Tensor] = [None] * p_total
    xs[0], ys[0], ms[0] = xi, yi, mi
    for p in range(1, p_total):
        par = int(comp.parentid[p])
        xs[p], ys[p], ms[p] = _unpack(
            tables[p][img, si, ms[par], ys[par], xs[par]]
        )

    root_scale = box_scales[si].to(dtype)
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
