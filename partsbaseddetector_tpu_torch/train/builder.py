"""Model construction for training: initmodel, part-type clustering,
tree assembly, model merging.

Python re-expressions of matlab/learning/{initmodel.m, clusterparts.m,
data_def.m, buildmodel.m, mergemodels.m} against the canonical Model.
The flat `.i` offset bookkeeping of the MATLAB structs is replaced by
the pool indices the canonical model already carries (train/layout.py
materializes flat offsets when the QP needs them).

A NumPy copy of `partsbaseddetector_tpu/train/builder.py`,
kept verbatim so that the port never imports the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..models.model import FLEN, Model


def init_part_model(
    box_sizes: Sequence[Tuple[float, float]],
    sbin: int = 8,
    tsize: Optional[Tuple[int, int]] = None,
    interval: int = 10,
    name: str = "part",
) -> Model:
    """Single-part, single-mixture starter model (initmodel.m): the
    template area is the 5th-percentile annotated box area."""
    if tsize is None:
        areas = np.sort([w * h for (h, w) in box_sizes])
        area = areas[int(np.floor(len(areas) * 0.05))]
        side = np.sqrt(area)
        tsize = (int(side // sbin), int(side // sbin))
    fh, fw = max(tsize[0], 1), max(tsize[1], 1)
    return Model(
        name=name,
        interval=interval,
        sbin=sbin,
        thresh=0.0,
        filters=[np.zeros((fh, fw, FLEN), dtype=np.float32)],
        defs=[],
        anchors=[],
        biases=np.zeros(1, dtype=np.float32),
        parentid=[np.zeros(1, dtype=np.int32)],
        filterid=[[np.zeros(1, dtype=np.int32)]],
        defid=[[np.zeros(0, dtype=np.int32)]],
        biasid=[[np.zeros((1, 1), dtype=np.int32)]],
        maxsize=(fh, fw),
    )


def relative_part_positions(
    keypoints: np.ndarray, box_sizes: np.ndarray, maxsize: Tuple[int, int]
) -> List[np.ndarray]:
    """data_def.m: part positions normalized to HOG-cell units via the
    per-example scale sqrt(area)/sqrt(template area).

    keypoints: (N, P, 2) (x, y); box_sizes: (N, 2) (h, w).
    Returns a list of (N, 2) arrays per part."""
    scale = np.sqrt(box_sizes[:, 0] * box_sizes[:, 1]) / np.sqrt(
        maxsize[0] * maxsize[1]
    )
    out = []
    for p in range(keypoints.shape[1]):
        out.append(keypoints[:, p, :] / scale[:, None])
    return out


def _kmeans(x: np.ndarray, k: int, rng: np.random.RandomState, iters=100):
    """Plain Lloyd's k-means, one restart (k_means.m analog)."""
    n = len(x)
    centers = x[rng.choice(n, k, replace=False)]
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d.argmin(1)
        if (new_assign == assign).all() and _ > 0:
            break
        assign = new_assign
        for j in range(k):
            pts = x[assign == j]
            if len(pts):
                centers[j] = pts.mean(0)
    dist = ((x - centers[assign]) ** 2).sum()
    return assign, centers, dist


def cluster_parts(
    deffeat: Sequence[np.ndarray],
    K: Sequence[int],
    pa: Sequence[int],
    restarts: int = 100,
    seed: int = 0,
) -> List[np.ndarray]:
    """Part-type clustering (clusterparts.m): k-means over each part's
    offset relative to its parent (the root uses its first child), best
    of `restarts` random restarts."""
    rng = np.random.RandomState(seed)
    P = len(deffeat)
    idx: List[np.ndarray] = []
    for p in range(P):
        if pa[p] == 0 and p == 0:
            child = next(i for i in range(P) if pa[i] == p and i != p)
            x = deffeat[child] - deffeat[p]
        else:
            x = deffeat[p] - deffeat[pa[p]]
        best = None
        for _ in range(restarts):
            assign, _, dist = _kmeans(x, K[p], rng)
            if best is None or dist < best[1]:
                best = (assign, dist)
        idx.append(best[0])
    return idx


def cluster_parts_poselet(
    deffeat: Sequence[np.ndarray],
    K: Sequence[int],
    co: np.ndarray,
    restarts: int = 100,
    seed: int = 0,
) -> List[np.ndarray]:
    """Poselet-style part-type clustering (clusterparts_poselet.m:1-26):
    instead of the single parent offset, each part p clusters on the
    concatenation of its offsets to every part i marked connected in the
    (P, P) 0/1 matrix `co` (co[p, i] == 1), k-means best of `restarts`.

    With `co` equal to the parent adjacency this reduces to
    cluster_parts; richer connectivity gives mixtures that encode whole
    local configurations (poselets)."""
    rng = np.random.RandomState(seed)
    P = len(deffeat)
    co = np.asarray(co)
    if co.shape != (P, P):
        raise ValueError(f"co must be ({P}, {P}), got {co.shape}")
    idx: List[np.ndarray] = []
    for p in range(P):
        cols = [deffeat[i] - deffeat[p] for i in range(P) if co[p, i] == 1]
        if not cols:
            raise ValueError(f"part {p} has no connected parts in co")
        x = np.concatenate(cols, axis=1)
        best = None
        for _ in range(restarts):
            assign, _, dist = _kmeans(x, K[p], rng)
            if best is None or dist < best[1]:
                best = (assign, dist)
        idx.append(best[0])
    return idx


def build_model(
    name: str,
    part_models: Sequence[Model],
    deffeat: Sequence[np.ndarray],
    idx: Sequence[np.ndarray],
    pa: Sequence[int],
    base: Model,
) -> Model:
    """Assemble the per-part mixture models into one tree model
    (buildmodel.m): root gets a single zero bias; every (parent-mixture,
    child-mixture) pair gets a zero pairwise bias; deformations
    initialize to [0.01 0 0.01 0] with the anchor at the rounded mean
    relative offset.

    part_models[p] must hold one filter per mixture of part p (the
    outputs of the per-part warped training stage).
    """
    P = len(pa)
    filters: List[np.ndarray] = []
    defs: List[np.ndarray] = []
    anchors: List[np.ndarray] = []
    biases: List[float] = []
    parentid = np.asarray(pa, dtype=np.int32)
    fid_c, did_c, bid_c = [], [], []

    for p in range(P):
        par = int(pa[p])
        kmax = int(idx[p].max()) + 1
        # bias table
        if p == 0:
            biases.append(0.0)
            bid = np.array([[len(biases) - 1]], dtype=np.int32)
        else:
            lpar = int(idx[par].max()) + 1
            bid = np.zeros((lpar, kmax), dtype=np.int32)
            for k in range(kmax):
                for l in range(lpar):
                    biases.append(0.0)
                    bid[l, k] = len(biases) - 1
        bid_c.append(bid)

        # filters, one per mixture
        fid = np.zeros(kmax, dtype=np.int32)
        for k in range(kmax):
            filters.append(
                np.asarray(part_models[p].filters[k], dtype=np.float32)
            )
            fid[k] = len(filters) - 1
        fid_c.append(fid)

        # deformations + anchors
        if p == 0:
            did_c.append(np.zeros(0, dtype=np.int32))
        else:
            did = np.zeros(kmax, dtype=np.int32)
            for k in range(kmax):
                sel = idx[p] == k
                ax = float(np.mean(deffeat[p][sel, 0] - deffeat[par][sel, 0]))
                ay = float(np.mean(deffeat[p][sel, 1] - deffeat[par][sel, 1]))
                defs.append(np.array([0.01, 0, 0.01, 0], dtype=np.float32))
                # buildmodel stores round([x+1 y+1 0]) 1-based; canonical
                # anchors are 0-based
                anchors.append(
                    np.array(
                        [int(round(ax + 1)) - 1, int(round(ay + 1)) - 1, 0],
                        dtype=np.int32,
                    )
                )
                did[k] = len(defs) - 1
            did_c.append(did)

    return Model(
        name=name,
        interval=base.interval,
        sbin=base.sbin,
        thresh=0.0,
        filters=filters,
        defs=defs,
        anchors=anchors,
        biases=np.asarray(biases, dtype=np.float32),
        parentid=[parentid],
        filterid=[fid_c],
        defid=[did_c],
        biasid=[bid_c],
        maxsize=base.maxsize,
    )


def merge_models(models: Sequence[Model]) -> Model:
    """Concatenate models as components of one mixture model
    (mergemodels.m)."""
    out = models[0]
    filters = list(out.filters)
    defs = list(out.defs)
    anchors = list(out.anchors)
    biases = list(np.asarray(out.biases))
    parentid = list(out.parentid)
    filterid = [list(c) for c in out.filterid]
    defid = [list(c) for c in out.defid]
    biasid = [list(c) for c in out.biasid]
    maxsize = out.effective_maxsize()

    for m in models[1:]:
        nb, nf, nd = len(biases), len(filters), len(defs)
        biases.extend(np.asarray(m.biases))
        filters.extend(m.filters)
        defs.extend(m.defs)
        anchors.extend(m.anchors)
        for c in range(m.ncomponents):
            parentid.append(np.asarray(m.parentid[c]))
            filterid.append([fid + nf for fid in m.filterid[c]])
            defid.append([did + nd for did in m.defid[c]])
            biasid.append([bid + nb for bid in m.biasid[c]])
        ms = m.effective_maxsize()
        maxsize = (max(maxsize[0], ms[0]), max(maxsize[1], ms[1]))

    return Model(
        name=out.name,
        interval=out.interval,
        sbin=out.sbin,
        thresh=min(m.thresh for m in models),
        filters=filters,
        defs=defs,
        anchors=anchors,
        biases=np.asarray(biases, dtype=np.float32),
        parentid=parentid,
        filterid=filterid,
        defid=defid,
        biasid=biasid,
        maxsize=maxsize,
    )
