"""Plain reference of the flexible-mixtures-of-parts detector.

The detector of Yang & Ramanan (CVPR 2011) and Zhu & Ramanan (CVPR
2012) as plain torch operations on whole tensors, written from the
published MATLAB code (featpyramid.m, features.cc, resize.cc, reduce.cc,
fconv.cc, shiftdt.cc, detect_fast.m) and nothing else. It runs on any
torch device (the card with TF32 off, or the CPU), and imports nothing
of the program it judges.

    frame (H, W, 3) uint8
      -> image pyramid: `interval` area resizes of the frame per octave,
         then repeated half-size binomial reduces, each level rounded to
         float32 once (the resampling sums in float64); the model's
         `pyramid` names the form (below)
      -> 32-channel HOG per level (float64 histograms; the gradient, the
         strongest colour channel and the orientation choice in float32,
         the precision the f32 profile states), padded by (pad+1) cells
         with the occlusion channel set to 1 on the pad frame
      -> valid correlation with every filter of the pool at its own
         size, once a level (float64); a level's maps share the grid of
         its smallest filter, each -inf beyond its own valid extent
      -> tree DP per root level and component, on the responses of the
         filters that the component's parts name, each part on its own
         level: for each part from the leaves up, the generalized
         distance transform of each of its mixtures by brute force
         (every source cell against every output cell, first maximum
         wins) onto its parent's grid, then the max over the child's
         mixtures with the (parent mixture, child mixture) bias table
         (`root_scores`; `component_root_scores` runs the parts of every
         component at one depth together, to the same bits)
      -> root score = max over root mixtures of root score + root bias.

A model is a pool of filters and a list of trees, one a component, of
any sizes and depths (the shared models of Zhu & Ramanan; a one-tree
model is one component). Every (component, level, root cell) whose score
is at least the threshold is a detection, best first across components,
as detect.m gathers them before any NMS. `placement_score` evaluates
placements of one component (a root cell, every part's cell and mixture)
by the same terms, so that a detector's claimed parts can be scored
without retracing its own argmax choices.

Octave-offset parts follow detect_fast.m:93-105: a part whose octave
offsets down the tree add up to d reads level l - d * interval at root
level l; its distance transform runs on that finer grid and samples it
with step 2^ds (its own offset) onto its parent's grid, which starts
(2^ds - 1) * pad cells in (the virtual padding of the finer octave).
A root level with no level d * interval below it, for a component's
largest d, carries no root of that component (-inf), as the finer
level does not exist.

The pyramid takes one of two forms (`Model.pyramid`):

    "pose"  the pose and face releases' featpyramid.m
            (pose-release-ver1.3, face-release1.0-basic): 1 + floor(
            log(min(H, W) / (5 sbin)) / log(sc)) levels, sc = 2^(1 /
            interval), all at sbin: level i < interval is
            hog(resize(frame, 1 / sc^i), sbin) at sbin sc^i pixels a
            cell, and each later octave a reduce of the level an octave
            above, at twice its scale
    "dpm"   voc-release4's featpyramid.m (Felzenszwalb, Girshick,
            McAllester, Ramanan): interval more levels, an octave of HOG
            at sbin / 2 first: level i < interval is hog(resize(frame, 1
            / sc^i), sbin / 2) at (sbin / 2) sc^i pixels a cell, level i
            + interval is hog of the same image at sbin, at sbin sc^i,
            and each later octave hog at sbin of resize(., 0.5) of the
            image an octave above, at twice its scale. With its parts at
            ds = 1 a root lies on levels interval and up (detect.m), its
            parts on the half-cell octave below

In both the frame itself is level 0's image (a resize at scale 1 is
skipped), and every level is padded alike.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# 9 orientation unit vectors of a half circle (features.cc:8-25)
HOG_UU = (1.0000, 0.9397, 0.7660, 0.5000, 0.1736, -0.1736, -0.5000, -0.7660, -0.9397)
HOG_VV = (0.0000, 0.3420, 0.6428, 0.8660, 0.9848, 0.9848, 0.8660, 0.6428, 0.3420)
HOG_EPS = 0.0001
NORIENT = 18
F64 = torch.float64
# maps in one brute-force distance transform call: its passes hold
# (maps, H, H, W) and (maps, H, W, W) float64, ~1.4 and ~1.8 GB at VGA's
# finest level
DT_MAPS = 64


def cround(x: float) -> int:
    """C round(): halves away from zero (MATLAB's round as well)."""
    return int(math.floor(x + 0.5)) if x >= 0 else -int(math.floor(-x + 0.5))


# ---------------------------------------------------------------------------
# resampling (resize.cc, reduce.cc)
# ---------------------------------------------------------------------------


def resize_weights(src_len: int, dst_len: int) -> np.ndarray:
    """Area-averaging weights, (dst_len, src_len) float64: output d
    integrates the source interval [d*inv, (d+1)*inv), inv = src/dst,
    scaled by dst/src; fractions under 1e-3 dropped (resize.cc:38-65)."""
    w = np.zeros((dst_len, src_len), dtype=np.float64)
    scale = dst_len / src_len
    inv = src_len / dst_len
    for d in range(dst_len):
        f1 = d * inv
        f2 = f1 + inv
        s1 = int(np.ceil(f1))
        s2 = int(np.floor(f2))
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] += (s1 - f1) * scale
        for s in range(s1, s2):
            w[d, s] += scale
        if f2 - s2 > 1e-3 and s2 < src_len:
            w[d, s2] += (f2 - s2) * scale
    return w


def reduce_weights(src_len: int) -> np.ndarray:
    """Half-size 5-tap binomial weights, (round(src/2), src_len) float64,
    with reduce.cc's boundary stencils (reduce.cc:22-42)."""
    dst_len = cround(src_len * 0.5)
    w = np.zeros((dst_len, src_len), dtype=np.float64)
    w[0, 0:3] = [0.6875, 0.25, 0.0625]
    for d in range(1, dst_len - 2):
        w[d, 2 * d - 2 : 2 * d + 3] = [0.0625, 0.25, 0.375, 0.25, 0.0625]
    if dst_len >= 3:
        d = dst_len - 2
        if dst_len * 2 <= src_len:
            w[d, 2 * d - 2 : 2 * d + 3] = [0.0625, 0.25, 0.375, 0.25, 0.0625]
        else:
            w[d, 2 * d - 2 : 2 * d + 2] = [0.0625, 0.25, 0.375, 0.3125]
    if dst_len >= 2:
        d = dst_len - 1
        w[d, 2 * d - 2 : 2 * d + 1] = [0.0625, 0.25, 0.6875]
    return w


def _separable(im: torch.Tensor, wh: np.ndarray, ww: np.ndarray) -> torch.Tensor:
    """(h, w, 3) float32 -> (dh, dw, 3) float32: both passes in float64,
    rounded once."""
    a = torch.as_tensor(wh, dtype=F64, device=im.device)
    b = torch.as_tensor(ww, dtype=F64, device=im.device)
    return torch.einsum("ij,jkc,lk->ilc", a, im.to(F64), b).to(torch.float32)


def resize(im: torch.Tensor, scale: float) -> torch.Tensor:
    h, w = im.shape[:2]
    return _separable(im, resize_weights(h, cround(h * scale)),
                      resize_weights(w, cround(w * scale)))


def reduce(im: torch.Tensor) -> torch.Tensor:
    h, w = im.shape[:2]
    return _separable(im, reduce_weights(h), reduce_weights(w))


# ---------------------------------------------------------------------------
# HOG (features.cc)
# ---------------------------------------------------------------------------


def _cell_weights(n_pix: int, n_cells: int, sbin: int, device) -> torch.Tensor:
    """(n_cells, n_pix) trilinear weights of pixels 1 .. n_pix on the
    visible grid: pixel q sits at (q + 0.5)/sbin - 0.5 cells and splits
    between the two cells around it (features.cc:111-119)."""
    w = torch.zeros((n_cells, n_pix), dtype=F64)
    q = torch.arange(1, n_pix + 1, dtype=F64)
    pos = (q + 0.5) / sbin - 0.5
    lo = torch.floor(pos)
    frac = pos - lo
    lo = lo.to(torch.int64)
    cols = torch.arange(n_pix)
    ok = lo >= 0
    w[lo[ok], cols[ok]] += 1.0 - frac[ok]
    ok = lo + 1 < n_cells
    w[lo[ok] + 1, cols[ok]] += frac[ok]
    return w.to(device)


def hog(im: torch.Tensor, sbin: int) -> torch.Tensor:
    """(h, w, 3) float32 image -> (bh-2, bw-2, 32) float64 features: 18
    contrast-sensitive, 9 insensitive, 4 texture channels and a zero
    occlusion channel."""
    h, w = im.shape[:2]
    bh, bw = cround(h / sbin), cround(w / sbin)
    oh, ow = max(bh - 2, 0), max(bw - 2, 0)
    vh, vw = bh * sbin, bw * sbin
    dev = im.device
    # pixels 1 .. v-2 of the visible grid, reads clamped to the image
    ys = torch.arange(1, vh - 1, device=dev).clamp(max=h - 2)
    xs = torch.arange(1, vw - 1, device=dev).clamp(max=w - 2)
    dy = im[ys + 1][:, xs] - im[ys - 1][:, xs]
    dx = im[ys][:, xs + 1] - im[ys][:, xs - 1]
    v = dx * dx + dy * dy
    # the strongest channel, the first at a tie
    ci = torch.argmax(v, dim=-1, keepdim=True)
    gdx = torch.gather(dx, -1, ci)[..., 0]
    gdy = torch.gather(dy, -1, ci)[..., 0]
    gv = torch.gather(v, -1, ci)[..., 0]
    uu = torch.tensor(HOG_UU, dtype=torch.float32, device=dev)
    vv = torch.tensor(HOG_VV, dtype=torch.float32, device=dev)
    dots = gdx[..., None] * uu + gdy[..., None] * vv
    # features.cc keeps the first of dot_0, -dot_0, dot_1, ... that is
    # strictly larger than every one before it
    inter = torch.stack([dots, -dots], dim=-1).reshape(*dots.shape[:-1], NORIENT)
    idx = torch.argmax(inter, dim=-1)
    best_o = (idx // 2) + (NORIENT // 2) * (idx % 2)
    mag = torch.sqrt(gv.to(F64))
    onehot = F.one_hot(best_o, NORIENT).to(F64) * mag[..., None]
    wy = _cell_weights(vh - 2, bh, sbin, dev)
    wx = _cell_weights(vw - 2, bw, sbin, dev)
    hist = torch.einsum("ay,yxo,bx->abo", wy, onehot, wx)

    half = NORIENT // 2
    norm = ((hist[..., :half] + hist[..., half:]) ** 2).sum(-1)
    s2 = norm[:-1, :-1] + norm[:-1, 1:] + norm[1:, :-1] + norm[1:, 1:]
    inv = 1.0 / torch.sqrt(s2 + HOG_EPS)
    ns = torch.stack([inv[1 : 1 + oh, 1 : 1 + ow], inv[0:oh, 1 : 1 + ow],
                      inv[1 : 1 + oh, 0:ow], inv[0:oh, 0:ow]], dim=-1)
    src = hist[1 : 1 + oh, 1 : 1 + ow]
    hc = torch.clamp(src[..., None] * ns[..., None, :], max=0.2)  # (oh, ow, 18, 4)
    sens = 0.5 * hc.sum(-1)
    texture = 0.2357 * hc.sum(-2)
    both = src[..., :half] + src[..., half:]
    insens = 0.5 * torch.clamp(both[..., None] * ns[..., None, :], max=0.2).sum(-1)
    occl = torch.zeros((oh, ow, 1), dtype=F64, device=dev)
    return torch.cat([sens, insens, texture, occl], dim=-1)


# ---------------------------------------------------------------------------
# pyramid (featpyramid.m)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Tree:
    """One component: parts root first, parent[p] < p; every part has K
    mixtures; filterid[p, k] the pool filter of part p's mixture k;
    defs[p, k] = (ax, bx, ay, by) positive quadratic costs, anchors[p, k]
    = (dx, dy) cell offsets from the parent, bias[p, l, k] the bias of
    mixture k under parent mixture l (the root's in bias[0, 0]); ds[p]
    = 1 where part p lies one octave finer than its parent (None: every
    part on its parent's level)."""

    parent: List[int]
    filterid: torch.Tensor  # (P, K) int64
    defs: torch.Tensor  # (P, K, 4)
    anchors: torch.Tensor  # (P, K, 2) int64
    bias: torch.Tensor  # (P, K, K); the root's (1, K) table in bias[0, :1]
    ds: Optional[torch.Tensor] = None  # (P,) int64

    def octaves(self) -> List[int]:
        """Each part's octaves below the root: the ds on its path up,
        summed."""
        ds = self.ds.tolist() if self.ds is not None else [0] * len(self.parent)
        out = [0] * len(ds)
        for p in range(1, len(ds)):
            out[p] = out[self.parent[p]] + ds[p]
        return out


PYRAMIDS = ("pose", "dpm")


@dataclasses.dataclass
class Model:
    """A pool of filters and the trees (components) that index it:
    filter f is filters[f, :fh, :fw] for (fh, fw) = sizes[f] (None: the
    bank's size), the pyramid pads by maxsize (None: the bank's) and
    takes the form `pyramid` (the module's docstring)."""

    filters: torch.Tensor  # (F, fh_max, fw_max, 32)
    trees: List[Tree]
    interval: int
    sbin: int
    thresh: float
    sizes: Optional[torch.Tensor] = None  # (F, 2) int64 as (fh, fw)
    maxsize: Optional[Tuple[int, int]] = None
    pyramid: str = "pose"

    def __post_init__(self):
        if self.pyramid not in PYRAMIDS:
            raise ValueError(f"pyramid {self.pyramid!r} is not one of {PYRAMIDS}")

    @property
    def pad(self):
        """(pady, padx) = maxsize - 2 (featpyramid.m:11-12)."""
        fh, fw = self.maxsize if self.maxsize is not None else self.filters.shape[1:3]
        return max(fh - 2, 0), max(fw - 2, 0)

    @functools.cached_property
    def forest(self) -> "Forest":
        return Forest.of(self.trees, self.pad)


@dataclasses.dataclass
class Forest:
    """Every tree's parts as one list of nodes, tree after tree in part
    order, and the DP's schedule over them: the depths from the deepest
    up, each the nodes at that depth and the rounds in which they pass
    their messages up, round r taking each parent's r-th child in
    descending part order (each parent once a round). Each node's DT
    starts at shift = anchor - (step - 1) * pad on its source grid and
    samples it with its step, 2^ds; it reads the level ds_total octaves
    below its root's."""

    filterid: torch.Tensor  # (N, K)
    defs: torch.Tensor  # (N, K, 4)
    shift: torch.Tensor  # (N, K, 2) as (x, y)
    step: torch.Tensor  # (N,) int64
    ds_total: List[int]
    bias: torch.Tensor  # (N, K, K)
    roots: torch.Tensor  # (C,) each tree's root node
    steps: List[Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]]

    @staticmethod
    def of(trees: List[Tree], pad: Tuple[int, int]) -> "Forest":
        dev = trees[0].defs.device
        up, depth, roots, ds_total = [], [], [], []
        for t in trees:
            base = len(up)
            roots.append(base)
            ds_total += t.octaves()
            for p, q in enumerate(t.parent):
                up.append(base + q)
                depth.append(depth[base + q] + 1 if p else 0)
        ix = lambda a: torch.tensor(a, dtype=torch.int64, device=dev)
        steps = []
        for d in range(max(depth), 0, -1):
            nodes = [n for n in range(len(up)) if depth[n] == d]
            row = {n: i for i, n in enumerate(nodes)}
            rounds, taken = [], {}
            for n in reversed(nodes):
                r = taken[up[n]] = taken.get(up[n], -1) + 1
                if r == len(rounds):
                    rounds.append(([], []))
                rounds[r][0].append(row[n])
                rounds[r][1].append(up[n])
            steps.append((ix(nodes), [(ix(a), ix(b)) for a, b in rounds]))
        cat = lambda name: torch.cat([getattr(t, name) for t in trees])
        step = ix([1 << (ds_total[n] - ds_total[up[n]]) for n in range(len(up))])
        virtual = (step - 1)[:, None, None] * ix([pad[1], pad[0]])
        return Forest(cat("filterid"), cat("defs"), cat("anchors") - virtual, step, ds_total,
                      cat("bias"), ix(roots), steps)


def pyramid(frame: torch.Tensor, model: Model):
    """Padded features and box scales of every level of a (H, W, 3)
    uint8 frame, in the model's form."""
    im = frame.to(torch.float32)
    h, w = im.shape[:2]
    sc = 2.0 ** (1.0 / model.interval)
    n = 1 + int(math.floor(math.log(min(h, w) / (5.0 * model.sbin)) / math.log(sc)))
    if model.pyramid == "dpm":
        feats, scales = _dpm_levels(im, model, sc, n)
        return _padded(feats, model), scales
    feats: List[torch.Tensor] = [None] * n
    scales = [0.0] * n
    for i in range(min(model.interval, n)):
        scaled = resize(im, 1.0 / sc**i) if i > 0 else im
        feats[i] = hog(scaled, model.sbin)
        scales[i] = model.sbin * sc**i
        j = i + model.interval
        while j < n:
            scaled = reduce(scaled)
            feats[j] = hog(scaled, model.sbin)
            scales[j] = 2.0 * scales[j - model.interval]
            j += model.interval
    return _padded(feats, model), scales


def _dpm_levels(im: torch.Tensor, model: Model, sc: float, n: int):
    """Unpadded features and box scales of voc-release4's n + interval
    levels (featpyramid.m): phase i's image at sbin / 2 (level i) and at
    sbin (level i + interval), then at sbin after each area resize by
    0.5 (an octave further down each time)."""
    interval, sbin = model.interval, model.sbin
    total = n + interval
    feats: List[torch.Tensor] = [None] * total
    scales = [0.0] * total
    for i in range(min(interval, total)):
        scaled = resize(im, 1.0 / sc**i) if i > 0 else im
        feats[i] = hog(scaled, sbin // 2)
        scales[i] = sbin / 2 * sc**i
        j = i + interval
        if j < total:
            feats[j] = hog(scaled, sbin)
            scales[j] = sbin * sc**i
        j += interval
        while j < total:
            scaled = resize(scaled, 0.5)
            feats[j] = hog(scaled, sbin)
            scales[j] = 2.0 * scales[j - interval]
            j += interval
    return feats, scales


def _padded(feats: List[torch.Tensor], model: Model) -> List[torch.Tensor]:
    """Each level padded by (pad + 1) cells, the occlusion channel 1 on
    the pad frame (featpyramid.m)."""
    pady, padx = model.pad
    py, px = pady + 1, padx + 1
    out = []
    for f in feats:
        f = F.pad(f, (0, 0, px, px, py, py))
        f[:py, :, -1] = 1.0
        f[-py:, :, -1] = 1.0
        f[:, :px, -1] = 1.0
        f[:, -px:, -1] = 1.0
        out.append(f)
    return out


# ---------------------------------------------------------------------------
# correlation, distance transform, tree DP
# ---------------------------------------------------------------------------


def responses(feat: torch.Tensor, filters: torch.Tensor,
              sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Valid correlation of (Hp, Wp, 32) features with each of the
    (N, fh_max, fw_max, 32) filters at its own size, sizes (N, 2) (None:
    the bank's) -> (N, Hp-fh_min+1, Wp-fw_min+1), float64, -inf beyond
    each filter's own (Hp-fh+1, Wp-fw+1) (fconv.cc)."""
    x = feat.permute(2, 0, 1)[None].to(F64)
    k = filters.permute(0, 3, 1, 2).to(F64)
    own = [tuple(size) for size in sizes.tolist()] if sizes is not None else []
    groups = dict.fromkeys(own)
    if len(groups) <= 1:
        return F.conv2d(x, k)[0]
    hp, wp = feat.shape[:2]
    out = torch.full((len(k), hp - min(h for h, _ in groups) + 1,
                      wp - min(w for _, w in groups) + 1), -math.inf, dtype=F64,
                     device=feat.device)
    for fh, fw in groups:
        rows = [f for f, size in enumerate(own) if size == (fh, fw)]
        out[rows, : hp - fh + 1, : wp - fw + 1] = F.conv2d(x, k[rows, :, :fh, :fw])[0]
    return out


def distance_transform(src: torch.Tensor, defs: torch.Tensor, shift: torch.Tensor,
                       out_h: int, out_w: int, step: Optional[torch.Tensor] = None):
    """out[k, y, x] = max over (v, u) of src[k, v, u] - ay*dy^2 - by*dy
    - ax*dx^2 - bx*dx, dy = shift_y + step*y - v, dx = shift_x + step*x
    - u, for y < out_h, x < out_w (the parent's grid), by brute force:
    the y pass, then the x pass on its output (shiftdt.cc). src (K, H, W)
    float64, defs (K, 4), shift (K, 2) as (x, y), step (K,) (None: 1)."""
    _, h, w = src.shape
    dev = src.device
    ax, bx, ay, by = (defs[:, i].to(F64)[:, None, None] for i in range(4))
    step = step[:, None, None] if step is not None else 1
    # y pass: (K, y_out, v)
    d = (shift[:, 1, None, None] + step * torch.arange(out_h, device=dev)[None, :, None]
         - torch.arange(h, device=dev)[None, None, :]).to(F64)
    cost = ay * d * d + by * d
    tmp = (src[:, None, :, :] - cost[..., None]).amax(dim=2)  # (K, y, W)
    # x pass: (K, x_out, u)
    d = (shift[:, 0, None, None] + step * torch.arange(out_w, device=dev)[None, :, None]
         - torch.arange(w, device=dev)[None, None, :]).to(F64)
    cost = ax * d * d + bx * d
    return (tmp[:, :, None, :] - cost[:, None, :, :]).amax(dim=3)


def root_scores(resp: torch.Tensor, tree: Tree) -> torch.Tensor:
    """The tree DP over one level's (P*K, Hr, Wr) responses of one tree's
    parts, part p's mixture k at p*K + k, part by part: the best score of
    a placement at every root cell, (Hr, Wr). The plain form of
    component_root_scores for a tree of parts on their parents' levels
    (ds = 0), which tests hold it to."""
    nparts = len(tree.parent)
    k = tree.defs.shape[1]
    score = [resp[p * k : (p + 1) * k].clone() for p in range(nparts)]
    for p in range(nparts - 1, 0, -1):
        par = tree.parent[p]
        msg0 = distance_transform(score[p], tree.defs[p], tree.anchors[p],
                                  *score[par].shape[1:])
        # (L, K, H, W): parent mixture l takes its best child mixture
        msg = (msg0[None] + tree.bias[p].to(F64)[:, :, None, None]).amax(dim=1)
        score[par] = score[par] + msg
    rootsc = score[0] + tree.bias[0].to(F64)[0][:, None, None]
    return rootsc.amax(dim=0)


def component_root_scores(resps: List[torch.Tensor], level: int, model: Model) -> torch.Tensor:
    """Every component's DP at root level `level`, over every level's
    (F, Hr, Wr) pool responses, each tree on the responses its parts
    index, each part on its own level: (C, Hr, Wr) on the root level's
    grid. root_scores' terms in its order, over the parts of every tree
    at once: the nodes of one depth, deepest first, go through the
    distance transform together (in calls of DT_MAPS maps), and each
    parent adds its children's messages in descending part order, so
    that each component's map is the one root_scores gives on that
    component alone, to the bit. The maps of one root level share the
    largest grid of the levels its parts read, -inf beyond each map's
    own; a part whose level does not exist reads -inf, so its tree has
    no root there."""
    fo = model.forest
    k = fo.defs.shape[1]
    reads = [level - d * model.interval for d in fo.ds_total]
    used = sorted({lv for lv in reads if lv >= 0})
    h = max(resps[lv].shape[1] for lv in used)
    w = max(resps[lv].shape[2] for lv in used)
    own = resps[level]
    score = torch.full((len(reads), k, h, w), -math.inf, dtype=own.dtype, device=own.device)
    for lv in used:
        nodes = [n for n, r in enumerate(reads) if r == lv]
        r = resps[lv]
        score[nodes, :, : r.shape[1], : r.shape[2]] = \
            r[fo.filterid[nodes].reshape(-1)].reshape(len(nodes), k, *r.shape[1:])
    for nodes, rounds in fo.steps:
        src = score[nodes].reshape(-1, h, w)
        defs = fo.defs[nodes].reshape(-1, 4)
        shift = fo.shift[nodes].reshape(-1, 2)
        step = fo.step[nodes].repeat_interleave(k)
        msg0 = torch.cat([distance_transform(src[i : i + DT_MAPS], defs[i : i + DT_MAPS],
                                             shift[i : i + DT_MAPS], h, w,
                                             step[i : i + DT_MAPS])
                          for i in range(0, src.shape[0], DT_MAPS)]).reshape(-1, k, h, w)
        # (n, L, K, H, W): parent mixture l takes its best child mixture
        msg = (msg0[:, None] + fo.bias[nodes].to(F64)[..., None, None]).amax(dim=2)
        for rows, parents in rounds:
            score[parents] = score[parents] + msg[rows]
    rootsc = score[fo.roots] + fo.bias[fo.roots, 0].to(F64)[..., None, None]
    return rootsc.amax(dim=1)[:, : own.shape[1], : own.shape[2]]


@dataclasses.dataclass
class Detection:
    """One frame's reference. Per level: the box scale, and, flattened
    into one tensor each, the pool's responses (F, Hr, Wr) and every
    component's root scores (C, Hr, Wr), with each level's offsets and
    (Hr, Wr); and the scores of every (component, root cell) at or above
    the threshold, best first."""

    scales: List[float]
    resp: torch.Tensor
    resp_off: torch.Tensor
    root: torch.Tensor
    root_off: torch.Tensor
    grid: torch.Tensor  # (levels, 2) as (Hr, Wr)
    scores: torch.Tensor


def _flat(maps: List[torch.Tensor]):
    sizes = torch.tensor([m.numel() for m in maps])
    off = torch.cumsum(sizes, 0) - sizes
    return torch.cat([m.reshape(-1) for m in maps]), off.to(maps[0].device)


def detect(frame: torch.Tensor, model: Model) -> Detection:
    feats, scales = pyramid(frame, model)
    resp = [responses(f, model.filters, model.sizes) for f in feats]
    root = [component_root_scores(resp, level, model) for level in range(len(resp))]
    grid = torch.tensor([r.shape[1:] for r in root], device=frame.device)
    resp, resp_off = _flat(resp)
    root, root_off = _flat(root)
    kept = root[root >= model.thresh]
    return Detection(scales, resp, resp_off, root, root_off, grid,
                     torch.sort(kept, descending=True).values)


def _gather(flat, off, grid, level, planes, ys, xs):
    """flat[level's map][plane, y, x], -inf off the level's grid; level
    as ys and xs, or broadcast to them."""
    h, w = grid[level, 0], grid[level, 1]
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    idx = off[level] + (planes * h + ys.clamp(min=0).minimum(h - 1)) * w \
        + xs.clamp(min=0).minimum(w - 1)
    val = flat[idx]
    return torch.where(inside, val, torch.full_like(val, -math.inf))


def placement_score(det: Detection, model: Model, c: int, level: torch.Tensor,
                    xs: torch.Tensor, ys: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """The score of N placements of component c by the DP's terms: every
    part's response at its cell and mixture, less its deformation from
    the cell its DT reads for its parent's cell (anchor - (step - 1) *
    pad + step * the parent's cell, step 2^ds), plus the bias of its
    (parent mixture, mixture) and the root's bias. level, xs, ys, mix
    (N, P_c) int64: each part's level, and its cell on that level's
    grid. Cells outside the grid score -inf."""
    tree = model.trees[c]
    nparts = xs.shape[1]
    dev = xs.device
    planes = tree.filterid.to(dev)[torch.arange(nparts, device=dev)[None, :], mix]
    total = _gather(det.resp, det.resp_off, det.grid, level, planes, ys, xs).sum(1)
    bias = tree.bias.to(F64)
    total = total + bias[0, 0][mix[:, 0]]
    par = torch.tensor(tree.parent[1:], device=dev)
    ch = torch.arange(1, nparts, device=dev)[None, :]
    m = mix[:, 1:]
    a = tree.anchors[ch, m]
    step = 1 << (tree.ds[1:] if tree.ds is not None else torch.zeros_like(par)).to(dev)
    pady, padx = model.pad
    dx = (a[..., 0] - (step - 1) * padx + step * xs[:, par] - xs[:, 1:]).to(F64)
    dy = (a[..., 1] - (step - 1) * pady + step * ys[:, par] - ys[:, 1:]).to(F64)
    ax, bx, ay, by = tree.defs[ch, m].to(F64).unbind(-1)
    total = total - (ax * dx * dx + bx * dx + ay * dy * dy + by * dy).sum(1)
    return total + bias[ch, mix[:, par], m].sum(1)


def root_score_at(det: Detection, c: int, level: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """The reference's best score of component c at root cells (x, y) of
    their levels; -inf outside the grid."""
    plane = torch.full_like(x, c)
    return _gather(det.root, det.root_off, det.grid, level[:, None], plane[:, None],
                   y[:, None], x[:, None])[:, 0]


def model_from_arrays(arrays: Dict[str, object], interval: int, sbin: int,
                      thresh: float, pyramid: str = "pose") -> Model:
    """The Model of the benchmark's generated arrays (lib/inputs.py),
    its pyramid of the form `pyramid`."""
    trees = []
    for c, t in enumerate(arrays["trees"]):
        parent = [int(p) for p in t["parent"].tolist()]
        for p, q in enumerate(parent[1:], start=1):
            if not 0 <= q < p:
                raise ValueError(f"component {c}, part {p}: parent {q} must come before it")
        trees.append(Tree(parent=parent, filterid=t["filterid"].to(torch.int64),
                          defs=t["defs"], anchors=t["anchors"].to(torch.int64),
                          bias=t["bias"], ds=t["ds"].to(torch.int64)))
    return Model(filters=arrays["filters"], trees=trees, interval=int(interval),
                 sbin=int(sbin), thresh=float(thresh), sizes=arrays["sizes"],
                 maxsize=tuple(arrays["maxsize"]), pyramid=pyramid)
