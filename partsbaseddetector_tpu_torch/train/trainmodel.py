"""Full training driver: annotation -> clustered part types -> warped
per-part SVMs -> tree assembly -> latent retraining.

Python re-expression of matlab/learning/trainmodel.m with the same
stage structure and crash-resume stage caching (trainmodel.m:8-22 /
globals.m cache dir): every stage writes its result to cachedir and is
skipped on re-entry.

    model = train_model(name, positives, negatives, K, pa, sbin)

positives: dicts {'im', 'points' (P, 2)}; negatives: dicts {'im'}.
K[p] = mixture count per part; pa = parent indices (pa[0] == 0).
c_svm/wpos are the SVM regularization constants (train.m:31 defaults
C=0.002, wpos=2 — tuned for thousands of real examples; small or
low-contrast synthetic sets need a larger C or the regularized optimum
is the zero filter).

A copy of `partsbaseddetector_tpu/train/trainmodel.py` with one
addition: `device` goes through to latent.train, whose miner runs there.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from ..models.model import Model
from ..utils.device import resolve_device
from .builder import (
    build_model,
    cluster_parts,
    init_part_model,
    relative_part_positions,
)
from .data import point_to_box, crop_positive
from .latent import train


def _cache(cachedir: Optional[str], key: str, fn):
    """Stage cache: load if present, else compute + persist."""
    if cachedir is None:
        return fn()
    path = os.path.join(cachedir, key + ".pkl")
    if os.path.exists(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    val = fn()
    os.makedirs(cachedir, exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(val, fh)
    return val


def train_model(
    name: str,
    positives: Sequence[Dict],
    negatives: Sequence[Dict],
    K: Sequence[int],
    pa: Sequence[int],
    sbin: int = 8,
    interval: int = 10,
    cachedir: Optional[str] = None,
    max_warp_negatives: int = 100,
    warp_iters: int = 2,
    latent_iters: int = 2,
    nmax: int = 2000,
    c_svm: float = 0.002,
    wpos: float = 2.0,
    verbose: bool = False,
    device="cuda",
) -> Model:
    """device: where latent.train's miner runs (train/detect_tpu.py);
    "cuda" (the default) raises at once on a machine without a card, so
    pass device="cpu" to train on the CPU."""
    resolve_device(device)
    P = len(pa)
    positives = _cache(
        cachedir, f"{name}_boxes", lambda: point_to_box(list(positives), pa)
    )
    positives = [crop_positive(ex) for ex in positives]

    box_sizes = [
        (
            ex["boxes"][0, 3] - ex["boxes"][0, 1] + 1,
            ex["boxes"][0, 2] - ex["boxes"][0, 0] + 1,
        )
        for ex in positives
    ]
    base = init_part_model(box_sizes, sbin=sbin, interval=interval, name=name)

    kps = np.stack([np.asarray(ex["points"])[:, :2] for ex in positives])
    sizes = np.array(
        [
            (
                ex["boxes"][0, 3] - ex["boxes"][0, 1] + 1,
                ex["boxes"][0, 2] - ex["boxes"][0, 0] + 1,
            )
            for ex in positives
        ]
    )
    deffeat = relative_part_positions(kps, sizes, base.effective_maxsize())
    idx = _cache(
        cachedir,
        f"{name}_clusters",
        lambda: cluster_parts(deffeat, K, pa),
    )

    # --- per-part, per-mixture warped SVMs (trainmodel.m:19-39)
    sneg = list(negatives)[:max_warp_negatives]

    def train_part(p: int) -> Model:
        pm = None
        filters = []
        for k in range(int(idx[p].max()) + 1):
            sel = np.flatnonzero(idx[p] == k)
            spos = []
            for n in sel:
                ex = dict(positives[n])
                ex["boxes"] = ex["boxes"][p : p + 1]
                spos.append(ex)
            m = init_part_model(
                [
                    (b[3] - b[1] + 1, b[2] - b[0] + 1)
                    for ex in spos
                    for b in [ex["boxes"][0]]
                ],
                sbin=sbin,
                tsize=base.filters[0].shape[:2],
                interval=interval,
                name=f"{name}_part{p}_mix{k}",
            )
            m = train(
                m,
                spos,
                sneg,
                warp=True,
                iters=warp_iters,
                nmax=nmax,
                c_svm=c_svm,
                wpos=wpos,
                verbose=verbose,
                device=device,
            )
            filters.append(m.filters[0])
            pm = m
        pm.filters = filters
        return pm

    part_models = [
        _cache(cachedir, f"{name}_part_{p}", lambda p=p: train_part(p))
        for p in range(P)
    ]

    # --- assemble the tree (trainmodel.m:46)
    model = _cache(
        cachedir,
        f"{name}_joint",
        lambda: build_model(name, part_models, deffeat, idx, pa, base),
    )

    # --- latent retraining: first with mixtures fixed to the cluster
    # labels, then free (trainmodel.m:47-64)
    fixed = np.stack([idx[p] for p in range(P)], axis=1)  # (N, P)

    def latent_fixed():
        return train(
            model,
            positives,
            negatives,
            warp=False,
            iters=latent_iters,
            nmax=nmax,
            c_svm=c_svm,
            wpos=wpos,
            fixed_mixtures=fixed,
            verbose=verbose,
            device=device,
        )

    model = _cache(cachedir, f"{name}_latent_fixed", latent_fixed)

    def latent_free():
        return train(
            model,
            positives,
            negatives,
            warp=False,
            iters=latent_iters,
            nmax=nmax,
            c_svm=c_svm,
            wpos=wpos,
            verbose=verbose,
            device=device,
        )

    model = _cache(cachedir, f"{name}_final", latent_free)
    model.name = name
    return model
