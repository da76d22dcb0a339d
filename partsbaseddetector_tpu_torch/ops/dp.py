"""Tree min-sum dynamic program + backtracking, batched over images and
scales.

Port of `partsbaseddetector_tpu/ops/dp.py` (`tree_min_sum` with its
unrolled level schedule, `backtrack_merged`, `backtrack`). Parts are
stored root-first (parentid[p] < p), so a leaves-to-root walk over tree
levels is a valid schedule. The unit of work is the level group of a
forest: every component a scale bucket scores, each tree's parts of one
depth whose grids, step and mixture count agree, across all the trees,
run as one gather of their responses, one add of their children's
messages, one batched 2-D distance transform, one mixture combine and a
scatter of the messages into the parents' sums per sibling rank, so
that every parent sums its children in the one-tree schedule's order
and the results are the one-tree DP's bit for bit (`forest_min_sum`;
`tree_min_sum` is the forest of one). That schedule, with every
host-to-device copy of the DP (the gather's rows, the DT's per-map
parameters, live counts and consumer extents, the biases, the scatter
indices), is `dp_plan`'s: it follows from the shapes and the model
alone, so the detector builds it once per shape and bucket and replays
the DP as a CUDA graph (ops/dp_graph.py).

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
DP: a group's gather takes each image's first S scales of a finer
bucket, so that aligning scales never mixes images, and its maps are
(G, B, S, M, H, W), flattened into the DT's batch of maps only at the
DT call, whose per-map parameters the plan built for that batch.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.model import DeviceComponent, PackedComponent
from .distance_transform import (
    DTMaps,
    dt_maps,
    shift_distance_transform_2d_maps,
    shift_distance_transform_2d_packed,
)

NEG_INF = -math.inf


def stable_top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, best first; ties keep index
    order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _depths(comp: PackedComponent) -> np.ndarray:
    depth = np.zeros(comp.nparts, dtype=np.int64)
    for p in range(1, comp.nparts):
        depth[p] = depth[int(comp.parentid[p])] + 1
    return depth


def _levels(comp: PackedComponent) -> Dict[int, List[int]]:
    depth = _depths(comp)
    levels: Dict[int, List[int]] = {}
    for p in range(1, comp.nparts):
        levels.setdefault(int(depth[p]), []).append(p)
    return levels


def _sibling_ranks(comp: PackedComponent) -> np.ndarray:
    """Each part's place among its parent's children in the one-tree
    schedule (levels leaves to root; in a level, the DT groups of
    (ds, parent ds, step) in the order their first part appears, then
    the parts in order): the order in which that schedule summed a
    parent's child messages, which the forest keeps bit for bit."""
    ds = comp.ds_total
    rank = np.zeros(comp.nparts, dtype=np.int64)
    taken: Dict[int, int] = {}
    for lvl, parts in sorted(_levels(comp).items(), reverse=True):
        keys: Dict[tuple, List[int]] = {}
        for p in parts:
            par = int(comp.parentid[p])
            keys.setdefault((int(ds[p]), int(ds[par]), int(comp.step[p])), []).append(p)
        for group in keys.values():
            for p in group:
                par = int(comp.parentid[p])
                rank[p] = taken.get(par, 0)
                taken[par] = rank[p] + 1
    return rank


class DPGroup(NamedTuple):
    """One batched 2-D DT of a forest's DP: every part, of any of its
    components, at one tree depth whose octave offset, parent's octave
    offset, step and mixture count M agree, with everything the group's
    gather, DT and combine read besides the responses, on their device.
    Its rows run (part, image, scale, mixture)-major in every tensor."""

    members: List[Tuple[int, int]]  # (component's place in the forest, part) a row
    mixtures: int  # M
    step: int
    bucket: int  # the bucket the parts read
    hr_par: int  # the parent grid: the DT's output size
    wr_par: int
    # (G*B*S*M,) int64: the rows of the bucket's (B*S_b*F, H, W)
    # filter-major responses that make the group's (G, B, S, M, H, W) scores
    rows: torch.Tensor
    pidx: torch.Tensor  # (G,) the parts (of the forest's one component if trainable)
    shift_x: torch.Tensor  # (G, 1, 1, M) f32
    shift_y: torch.Tensor
    # the DT's per-map parameters (ops/distance_transform.py::dt_maps) and
    # the combine's bias (G, M, M) [l, k] in the DP dtype; None where the
    # weights are trainable (then taken from the tensors at each call)
    maps: Optional[DTMaps]
    bias: Optional[torch.Tensor]


class RootGroup(NamedTuple):
    """The roots of the forest's components that share M and whether
    they have children: one gather, add and mixture max."""

    members: List[int]  # components' places in the forest
    mixtures: int
    rows: torch.Tensor  # (G*B*S*M,) as DPGroup.rows, of the root bucket
    root_bias: Optional[torch.Tensor]  # (G, 1, 1, M, 1, 1) in the DP dtype


class Scatter(NamedTuple):
    """One indexed add of child messages into their parents' sums: the
    rows [start, end) of a group's messages, every one its parent's
    child of one sibling rank, so that no parent is written twice."""

    child: int  # the group's index in DPPlan.groups
    start: int
    end: int
    # the parents' accumulator: a group's index in DPPlan.groups, or
    # len(groups) + a root group's index; its rows, and theirs here
    target: int
    target_rows: int
    at: torch.Tensor  # (end - start,) int64


class DPPlan(NamedTuple):
    """tree_min_sum's schedule over a forest: the components one bucket
    scores, each part in one DT group. `levels` runs leaves to root, each
    the range [lo, hi) of its groups and then its scatters in sibling
    rank order, so that every parent sums its children's messages in the
    one-tree schedule's order."""

    bucket_index: int
    ncomponents: int
    groups: List[DPGroup]
    levels: List[Tuple[int, int, List[Scatter]]]
    roots: List[RootGroup]


def dp_plan(
    resps: List[torch.Tensor],
    comps: List[PackedComponent],
    dcomps: List[DeviceComponent],
    valid_extents: Tuple[List[np.ndarray], List[np.ndarray]],
    bucket_index: int = 0,
    buckets_per_octave: int = 1,
    trainable: bool = False,
) -> DPPlan:
    """The DP's schedule for a forest of components over one scale
    bucket, with every host-to-device copy the DP makes: it depends on
    the maps' shapes, dtype and device (not their values), the model and
    the valid extents, so a caller that runs one shape again and again
    builds it once (the detector keeps one a bucket per image size and
    batch, and its CUDA graph replays the DP without a copy).

    The forest is what a bucket scores: every component with its root in
    the bucket (a one-tree model, and every trainable call, is a forest
    of one). A group holds every part, of any component, at one tree
    depth whose (ds, parent ds, step, M) agree, so its parts share the
    child grid, the parent grid and the DT's shape; its rows are sorted
    by (parent's group, sibling rank), so that each scatter of its
    messages is a contiguous slice. Arguments as tree_min_sum's, per
    component; trainable leaves out the weights and the live counts, and
    takes one component."""
    if trainable and len(comps) != 1:
        raise ValueError("a trainable DP runs one component a forest")
    if any(bucket_index < comp.max_ds * buckets_per_octave for comp in comps):
        raise ValueError(
            "root bucket must be at least max octave offset octaves coarse"
        )
    for r in resps:
        if r.shape[2] >= 4096 or r.shape[3] >= 4096:
            raise ValueError("packed pointers use 12 bits/coordinate")
    bucket_of = lambda d: bucket_index - d * buckets_per_octave
    root_resp = resps[bucket_of(0)]
    nimg, s = root_resp.shape[0], root_resp.shape[1]
    dev = root_resp.device
    dtype = root_resp.dtype
    nfilt = root_resp.shape[-1]

    def rows_of(bucket: int, fids: np.ndarray) -> torch.Tensor:
        """(G*B*S*M,) rows of the bucket's filter-major responses for the
        filter ids fids (G, M): image, scale and filter, row-major."""
        s_b = resps[bucket].shape[1]
        base = (np.arange(nimg)[:, None] * s_b + np.arange(s)[None, :]) * nfilt
        rows = base[None, :, :, None] + fids.astype(np.int64)[:, None, None, :]
        return torch.as_tensor(rows.reshape(-1), device=dev)

    def grid_of(c: int, p: int) -> Tuple[int, int]:
        r = resps[bucket_of(int(comps[c].ds_total[p]))]
        return r.shape[2], r.shape[3]

    def live_counts(c: int, p: int, w_child: int, hr_par: int):
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
        comp = comps[c]
        ds = comp.ds_total
        par = int(comp.parentid[p])
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

    # the groups: a depth's parts by (ds, parent ds, step, M), in the order
    # their first part appears; the roots by (M, has children)
    depths = [_depths(comp) for comp in comps]
    ranks = [_sibling_ranks(comp) for comp in comps]
    has_children = [set(int(q) for q in comp.parentid[1:]) for comp in comps]
    by_key: Dict[tuple, List[Tuple[int, int]]] = {}
    for c, comp in enumerate(comps):
        ds = comp.ds_total
        for p in range(1, comp.nparts):
            par = int(comp.parentid[p])
            key = (int(depths[c][p]), int(ds[p]), int(ds[par]), int(comp.step[p]),
                   comp.maxmix)
            by_key.setdefault(key, []).append((c, p))
    root_keys: Dict[tuple, List[int]] = {}
    for c, comp in enumerate(comps):
        root_keys.setdefault((comp.maxmix, 0 in has_children[c]), []).append(c)
    roots_members = list(root_keys.values())
    # groups leaves to root; a group's number is its place in that order
    keys = sorted(by_key, key=lambda k: -k[0])
    gid = {k: i for i, k in enumerate(keys)}
    ngroups = len(keys)
    # each part's accumulator target and row: roots first, then depth by
    # depth, since a group's row order follows its parents' rows
    target_of: Dict[Tuple[int, int], int] = {}
    row_of: Dict[Tuple[int, int], int] = {}
    for r, members in enumerate(roots_members):
        for i, c in enumerate(members):
            row_of[(c, 0)] = i
            target_of[(c, 0)] = ngroups + r
    members_of: Dict[int, List[Tuple[int, int]]] = {}
    for key in sorted(by_key, key=lambda k: k[0]):
        g = gid[key]
        for c, p in by_key[key]:
            target_of[(c, p)] = g
        parent_slot = lambda cp: (
            target_of[(cp[0], int(comps[cp[0]].parentid[cp[1]]))],
            int(ranks[cp[0]][cp[1]]),
        )
        members = sorted(by_key[key], key=lambda cp: (*parent_slot(cp), cp))
        for i, cp in enumerate(members):
            row_of[cp] = i
        members_of[g] = members

    sizes = {g: len(m) for g, m in members_of.items()}
    sizes.update({ngroups + r: len(m) for r, m in enumerate(roots_members)})
    groups: List[DPGroup] = []
    scatters: Dict[int, List[Tuple[int, Scatter]]] = {}
    for key in keys:
        depth, d_child, _, step, m = key
        g = gid[key]
        members = members_of[g]
        c0, p0 = members[0]
        hr_par, wr_par = grid_of(c0, int(comps[c0].parentid[p0]))
        h, w = grid_of(c0, p0)
        fids = np.stack([comps[c].filterid[p] for c, p in members])
        pidx = torch.as_tensor([p for _, p in members], device=dev)
        shift_x = torch.stack([dcomps[c].shift_x[p] for c, p in members])[:, None, None]
        shift_y = torch.stack([dcomps[c].shift_y[p] for c, p in members])[:, None, None]
        maps = bias = None
        if not trainable:
            # (G, 1, S, M[, W]): broadcast over the images
            nvys, nvxs, ovys, ovxs = (
                np.stack(x)[:, None] for x in zip(*(
                    live_counts(c, p, w, hr_par) for c, p in members
                ))
            )
            # the consumer extents also tell the DT that the shifts are
            # integral, which K5 needs: decided here, on the host copy
            shifts = np.stack([np.stack([comps[c].shift_x[p], comps[c].shift_y[p]])
                               for c, p in members])
            integral = np.array_equal(shifts, np.round(shifts))
            # the weights in the DP dtype, as tree_min_sum casts them
            defw = torch.stack([dcomps[c].defw.to(dtype)[p] for c, p in members])
            maps = dt_maps(
                (len(members), nimg, s, m, h, w), defw[:, None, None], shift_x, shift_y,
                wr_par, hr_par,
                torch.as_tensor(nvys, device=dev), torch.as_tensor(nvxs, device=dev),
                torch.as_tensor(ovys, device=dev) if integral else None,
                torch.as_tensor(ovxs, device=dev) if integral else None,
            )
            bias = torch.stack([dcomps[c].bias.to(dtype)[p] for c, p in members])
        groups.append(DPGroup(
            members, m, step, bucket_of(d_child), hr_par, wr_par,
            rows_of(bucket_of(d_child), fids), pidx, shift_x, shift_y, maps, bias,
        ))
        # one scatter a run of rows with one (target, rank)
        slots = [(target_of[(c, int(comps[c].parentid[p]))], int(ranks[c][p]))
                 for c, p in members]
        start = 0
        for i in range(1, len(members) + 1):
            if i == len(members) or slots[i] != slots[start]:
                tgt, rank = slots[start]
                at = [row_of[(c, int(comps[c].parentid[p]))] for c, p in members[start:i]]
                scatters.setdefault(depth, []).append((rank, Scatter(
                    g, start, i, tgt, sizes[tgt], torch.as_tensor(at, device=dev))))
                start = i
    levels = []
    for depth in sorted(scatters, reverse=True):
        ids = [gid[k] for k in keys if k[0] == depth]
        order = sorted(scatters[depth], key=lambda rs: rs[0])  # stable: by rank
        levels.append((min(ids), max(ids) + 1, [sc for _, sc in order]))

    roots: List[RootGroup] = []
    for members in roots_members:
        m = comps[members[0]].maxmix
        fids = np.stack([comps[c].filterid[0] for c in members])
        root_bias = None
        if not trainable:
            root_bias = torch.stack(
                [dcomps[c].root_bias.to(dtype) for c in members]
            )[:, None, None, :, None, None]
        roots.append(RootGroup(members, m, rows_of(bucket_index, fids), root_bias))
    return DPPlan(bucket_index, len(comps), groups, levels, roots)


def filter_major(resp: torch.Tensor) -> torch.Tensor:
    """A bucket's (B, S, Hr, Wr, F) responses as (B*S*F, Hr, Wr) rows,
    filter-major inside each image and scale, so that a group's gather
    reads whole contiguous maps."""
    nimg, s, h, w, f = resp.shape
    return resp.permute(0, 1, 4, 2, 3).reshape(nimg * s * f, h, w)


def _combine(dt: torch.Tensor, ptr: torch.Tensor, bias: torch.Tensor):
    """The mixture combine of a group, every part and parent mixture l
    at once: a first-max-wins where-chain over the child mixtures k.
    dt/ptr (G, B, S, K, Hp, Wp), bias (G, L, K) -> (msg, tbl) (G, B, S,
    L, Hp, Wp)."""
    b = bias[:, None, None, :, :, None, None]  # (G, 1, 1, L, K, 1, 1)
    best = dt[:, :, :, None, 0] + b[:, :, :, :, 0]
    ptrb = ptr[:, :, :, None, 0].expand_as(best)  # (0 << 24) | ptr
    for k in range(1, bias.shape[2]):
        val = dt[:, :, :, None, k] + b[:, :, :, :, k]
        pred = val > best
        best = torch.where(pred, val, best)
        ptrb = torch.where(pred, (k << 24) | ptr[:, :, :, None, k], ptrb)
    return best, ptrb


def forest_min_sum(
    resps: List[torch.Tensor],
    plan: DPPlan,
    tensors=None,
    layout: Optional[Dict[int, torch.Tensor]] = None,
):
    """Min-sum message passing over a forest: dp_plan's schedule on
    these responses, one gather, add, DT, combine and a scatter a sibling
    rank for each of its groups. resps as tree_min_sum's; tensors
    (optional): the forest's one component's trainable (defw, bias,
    root_bias), as tree_min_sum's; layout (optional): a dict of the
    buckets' filter-major responses (`filter_major`) that the forests of
    one call share, filled here as they are first read.
    Returns one (rootv, rooti, tables) a component of the forest, as
    tree_min_sum's: every tensor a view of its group's."""
    trainable = tensors is not None
    layout = {} if layout is None else layout
    if trainable:
        dtype = resps[plan.bucket_index].dtype
        defw_all, bias_all, root_bias = (t.to(dtype) for t in tensors)

    def scores(bucket: int, rows: torch.Tensor, m: int) -> torch.Tensor:
        if bucket not in layout:
            layout[bucket] = filter_major(resps[bucket])
        got = layout[bucket].index_select(0, rows)
        return got.view(-1, *resps[plan.bucket_index].shape[:2], m, *got.shape[1:])

    acc: Dict[int, torch.Tensor] = {}
    tables: List[Dict[int, torch.Tensor]] = [{} for _ in range(plan.ncomponents)]
    for lo, hi, scatters in plan.levels:
        msgs = []
        for i in range(lo, hi):
            g = plan.groups[i]
            score = scores(g.bucket, g.rows, g.mixtures)
            if i in acc:
                score = score + acc.pop(i)
            if trainable:
                dt, ptr = shift_distance_transform_2d_packed(
                    score, defw_all[g.pidx][:, None, None], g.shift_x, g.shift_y,
                    dlen_x=g.wr_par, dlen_y=g.hr_par, step=g.step, differentiable=True,
                )
                msg, tbl = _combine(dt, ptr, bias_all[g.pidx])
            else:
                dt, ptr = shift_distance_transform_2d_maps(
                    score, g.maps, g.wr_par, g.hr_par, g.step)
                msg, tbl = _combine(dt, ptr, g.bias)
            for r, (c, p) in enumerate(g.members):
                tables[c][p] = tbl[r]
            msgs.append(msg)
        for sc in scatters:
            src = msgs[sc.child - lo][sc.start:sc.end]
            into = acc.get(sc.target)
            if into is None:
                into = src.new_zeros((sc.target_rows, *src.shape[1:]))
            # out of place where autograd records the sums
            acc[sc.target] = (into.index_add(0, sc.at, src) if trainable
                              else into.index_add_(0, sc.at, src))

    out: List[tuple] = [None] * plan.ncomponents
    for r, rg in enumerate(plan.roots):
        root = scores(plan.bucket_index, rg.rows, rg.mixtures)
        key = len(plan.groups) + r
        if key in acc:
            root = root + acc.pop(key)
        root = root + (root_bias[None, None, None, :, None, None] if trainable
                       else rg.root_bias)
        rootv = root[:, :, :, 0]
        rooti = torch.zeros(rootv.shape, dtype=torch.int32, device=rootv.device)
        for m in range(1, rg.mixtures):
            pred = root[:, :, :, m] > rootv
            rootv = torch.where(pred, root[:, :, :, m], rootv)
            rooti = torch.where(pred, m, rooti)
        for i, c in enumerate(rg.members):
            out[c] = (rootv[i], rooti[i], tables[c])
    return out


def tree_min_sum(
    resps: List[torch.Tensor],
    comp: PackedComponent,
    dcomp: DeviceComponent,
    valid_extents: Tuple[List[np.ndarray], List[np.ndarray]],
    bucket_index: int = 0,
    buckets_per_octave: int = 1,
    tensors=None,
    plan: Optional[DPPlan] = None,
):
    """Min-sum message passing for one component over a scale bucket:
    `forest_min_sum` over the forest of one.

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
    plan (optional): dp_plan([comp], [dcomp], ...)'s schedule for these
        arguments, built here when not given; with it the DP copies
        nothing to the device.
    The weights are cast to the responses' dtype. With bf16 responses
    (the hybrid profile) the DTs widen their sources to f32 and return
    f32, so that a child's message, and every sum it enters, is f32 from
    there on: the dtypes of the JAX package's Pallas route on the chip.
    Returns (rootv (B, S, Hr, Wr), rooti int32, tables {p: packed int32
    pointers (B, S, L_parent, H_pargrid, W_pargrid)}).
    """
    if plan is None:
        plan = dp_plan(resps, [comp], [dcomp], valid_extents, bucket_index,
                       buckets_per_octave, tensors is not None)
    (out,) = forest_min_sum(resps, plan, tensors)
    return out


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
