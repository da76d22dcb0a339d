"""Latent structural-SVM training loop (the QP-faithful path).

Python re-expression of matlab/learning/train.m: warped-positive or
latent-positive feature writing, hard-negative mining through the
detector, dual coordinate-descent optimization, support-vector pruning,
and the 5th-percentile positive-score threshold. The TPU-native
subgradient path lives in train/sgd.py; this path reproduces the
reference's optimization semantics for capability parity and for
importing its training recipes.

Positives are dicts {'im', 'points', 'boxes' (P, 4)}; negatives are
dicts {'im'}.

A copy of `partsbaseddetector_tpu/train/latent.py` with one addition:
`device` goes through to the miner (train/detect_tpu.py::TPUMiner), and
the QP's placement features follow the miner. With the miner on the CPU
(device="cpu", or miner="reference") they are cut from the float64 NumPy
`feature_pyramid`, as in the JAX package. With the miner on the card
they are cut from the detect pipeline's own f32 pyramid
(ops/pyramid.py::PyramidKernels), because the NumPy pyramid takes
minutes per 240x320 frame at person26's sbin 4 and interval 10. The two
agree to f32 rounding, apart from HOG cells whose orientation choice is
a near-tie; a round's weights agree within 1e-6 on the CPU tier-1 case
(tests/test_torch_train_latent.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..models.model import Model
from ..ops import reference
from ..ops.pyramid import PyramidKernels
from ..ops.reference_pipeline import detect_reference, feature_pyramid
from .data import _imread, warp_positive_feature
from .features import Placement, placement_feature
from .layout import ParamLayout
from .qp import QPSolver


def warped_positive_phi(
    model: Model, layout: ParamLayout, ex: Dict, mixture: int = 0
) -> np.ndarray:
    """Feature for a warped positive of a single-part model
    (train.m poswarp): bias indicator + warped HOG block."""
    fidx = int(model.filterid[0][0][mixture])
    fsize = model.filters[fidx].shape[:2]
    feat = warp_positive_feature(ex, ex["boxes"][0], fsize, model.sbin)
    phi = np.zeros(layout.length)
    bidx = int(model.biasid[0][0][0, mixture])
    phi[layout.bias_off[bidx]] = 1.0
    off = layout.filter_off[fidx]
    phi[off : off + feat.size] = feat.ravel()
    return phi


def _feature_kernels(device):
    """The kernels of the QP features' pyramid for a miner on `device`."""
    if device.type == "cpu":
        return reference
    return PyramidKernels(device)


def train(
    model: Model,
    positives: Sequence[Dict],
    negatives: Sequence[Dict],
    warp: bool = False,
    iters: int = 3,
    c_svm: float = 0.002,
    wpos: float = 2.0,
    overlap: float = 0.6,  # train.m:40-41 default
    nmax: int = 2000,
    max_neg_per_image: int = 512,
    fixed_mixtures: Optional[np.ndarray] = None,
    tol: float = 0.05,
    seed: int = 0,
    verbose: bool = False,
    miner: str = "tpu",
    exhaust_negatives: int = 0,
    qp_memory_gb: Optional[float] = None,
    device="cuda",
) -> Model:
    """Train (or latently retrain) a model (train.m).

    warp=True uses warped positives as fixed support vectors (the
    per-part initialization stage); otherwise positives are mined
    latently with per-part ground-truth overlap constraints.

    miner: "tpu" (default) mines latent positives and hard negatives
    through the port's detect pipeline on `device` (train/detect_tpu.py:
    one plan per image shape and interval, kept across weight updates;
    device="cuda", the default, raises without a card, so pass
    device="cpu" on the CPU); "reference" keeps the loop-level NumPy
    pipeline (the exact train.m cost model, useful as an oracle). The
    QP's features follow the miner (see the module docstring).

    exhaust_negatives: extra re-mining passes per negative image. The
    miner returns a score-sorted top-K (static shapes for the jitted
    top_k), so one pass on a large image at interval 2 can miss
    above-threshold placements beyond K — a bounded residual of the
    reference's write-every-placement scan (detect.m:121-137). With
    exhaust_negatives=N, after the interleaved re-optimization each
    image is re-mined against the UPDATED weights up to N more times,
    writing only placements not yet seen, until a pass yields nothing
    new. Default 0: the residual matters mainly for tie-heavy
    degenerate inits, which the warped-positive stage resolves before
    latent rounds run (see DESIGN.md "mining semantics"); leaving it
    off keeps per-image mining single-pass like train.m's cost model.

    qp_memory_gb: when set, the example cache is sized from this memory
    budget with float32 block-sparse storage instead of a fixed nmax —
    the reference's scaling engineering (train.m:44-67 computes
    nmax = budget / sparselen(model) and stores single-precision
    block-sparse columns; qp_one_sparse.cc walks them). A person26-dim
    layout fits >5k mined examples in <1 GB this way; the dense float64
    default is the small-model oracle.
    """
    layout = ParamLayout.build(model)
    if qp_memory_gb is not None:
        from .qp import example_sparselen

        nnz, _ = example_sparselen(model)
        qp = QPSolver(
            layout,
            memory_gb=qp_memory_gb,
            example_nnz=nnz,
            cpos=c_svm * wpos,
            cneg=c_svm,
            seed=seed,
        )
    else:
        qp = QPSolver(
            layout, nmax=nmax, cpos=c_svm * wpos, cneg=c_svm, seed=seed
        )
    qp.set_w_from_model_vec(layout.model_to_vec(model))

    if miner not in ("tpu", "reference"):
        raise ValueError(f"unknown miner: {miner}")
    tpu_miner = None
    feature_kernels = reference
    if miner == "tpu":
        from .detect_tpu import TPUMiner

        tpu_miner = TPUMiner(
            model, max_det=max(64, max_neg_per_image), device=device
        )
        feature_kernels = _feature_kernels(tpu_miner.device)

    def mine(im, thresh, **kw):
        if tpu_miner is not None:
            return tpu_miner.detect(im, thresh=thresh, **kw)
        return detect_reference(im, model, thresh=thresh, **kw)

    def adopt(new_model):
        # weights changed: refresh the miner's device weights (its plans
        # stay valid: the structure is unchanged)
        if tpu_miner is not None:
            tpu_miner.set_model(new_model)
        return new_model

    warped_phi = None
    for it in range(iters):
        # everything is re-mined each iteration (train.m:75)
        qp.reset_examples()
        if warp:
            if warped_phi is None:
                warped_phi = [
                    warped_positive_phi(model, layout, ex) for ex in positives
                ]
            for i, phi in enumerate(warped_phi):
                qp.write(phi, (1, i + 1, 0, 0), label=1, fixed=True)
        else:
            # latent positives with the current model; examples smaller
            # than the template are skipped (train.m poslatent minsize)
            minsize = float(np.prod(np.asarray(model.effective_maxsize()) * model.sbin))
            for i, ex in enumerate(positives):
                boxes = np.asarray(ex["boxes"])
                areas = (boxes[:, 2] - boxes[:, 0] + 1) * (
                    boxes[:, 3] - boxes[:, 1] + 1
                )
                if np.any(areas < minsize):
                    continue
                im = _imread(ex)
                dets = mine(
                    im,
                    thresh=-1e8,
                    part_boxes=np.asarray(ex["boxes"]),
                    overlap=overlap,
                    fixed_mixtures=fixed_mixtures[i]
                    if fixed_mixtures is not None
                    else None,
                )
                if not dets:
                    continue
                d = dets[0]
                feats, _, _, _ = feature_pyramid(
                    im, model, kernels=feature_kernels
                )
                pl = Placement(
                    level=d["level"],
                    component=d["component"],
                    xs=d["xs"],
                    ys=d["ys"],
                    mixtures=d["mixtures"],
                )
                phi = placement_feature(model, layout, feats, pl)
                qp.write(phi, (1, i + 1, 0, 0), label=1, fixed=True)

        npos = int((qp.ids[: qp.n, 0] > 0).sum())
        if not warp and npos == 0:
            # a latent round with zero positives would collapse the QP
            # to the all-negative degenerate optimum (weights -> 0,
            # bias -> -1); keep the previous model instead
            import warnings

            warnings.warn(
                "latent round mined 0 positives (overlap constraint too "
                "strict for this grid?) — keeping the previous model"
            )
            return model

        # optimize on positives first (train.m:91-94)
        if qp.n:
            qp.prune()
            qp.opt(tol=tol)
            model = adopt(layout.vec_to_model(qp.actual_w(), model))

        # hard negative mining on a coarser pyramid (train.m:96-106
        # drops model.interval to 2 for speed). The reference writes
        # EVERY above-threshold placement into the QP — there is no
        # top-K (detect.m:121-137 scans the whole response map) — and
        # re-optimizes the model *during* mining (detect.m:147-151 +
        # optimize(): full opt+prune when the cache fills or lb < 0,
        # one coordinate pass otherwise), so later images are mined
        # against updated weights. Both behaviors are load-bearing:
        # without them a degenerate init (e.g. zero filter + bias,
        # where every placement ties) floods the cache with arbitrary
        # ties, boundary-occlusion cells never enter the QP, and the
        # learned model scores virtual padding above real content.
        # TPU-native deviations, both documented: the per-image miner
        # returns a fixed-size score-sorted top-K (max_neg_per_image,
        # static shapes for the jitted top_k) instead of scan-order
        # everything, and re-optimization happens per image instead of
        # per (component, level) — the pipeline computes all levels in
        # one device program, so per-image is the natural interleave
        # granularity.
        interval0 = model.interval
        model.interval = min(2, interval0)
        ub_run = max(qp.ub, 0.0) if np.isfinite(qp.ub) else 0.0
        for i, ex in enumerate(negatives):
            im = _imread(ex)
            feats = None
            seen = set()  # placements already written for this image
            for mine_pass in range(1 + max(0, exhaust_negatives)):
                dets = mine(im, thresh=-1.0)
                wrote = 0
                for d in dets[:max_neg_per_image]:
                    if qp.full:
                        break
                    key = (
                        d["level"],
                        d["component"],
                        int(d["xs"][0]),
                        int(d["ys"][0]),
                    )
                    if key in seen:
                        continue
                    seen.add(key)
                    if feats is None:
                        feats, _, _, _ = feature_pyramid(
                            im, model, kernels=feature_kernels
                        )
                    pl = Placement(
                        level=d["level"],
                        component=d["component"],
                        xs=d["xs"],
                        ys=d["ys"],
                        mixtures=d["mixtures"],
                    )
                    phi = placement_feature(model, layout, feats, pl)
                    qp.write(
                        phi,
                        (-1, i + 1, d["level"], int(d["xs"][0]),
                         int(d["ys"][0]))[:5],
                        label=-1,
                    )
                    # running upper-bound estimate (detect.m:135)
                    ub_run += c_svm * max(1.0 + d["score"], 0.0)
                    wrote += 1
                if wrote and (
                    qp.lb < 0
                    or ub_run <= 0
                    or 1 - qp.lb / ub_run > tol
                    or qp.full
                ):
                    if qp.lb < 0 or qp.full:
                        qp.opt(tol=tol)
                        qp.prune()
                    else:
                        qp.one()
                    ub_run = max(qp.ub, 0.0) if np.isfinite(qp.ub) else 0.0
                    model = adopt(layout.vec_to_model(qp.actual_w(), model))
                if wrote == 0 or qp.full:
                    # re-mining against the re-optimized weights found
                    # nothing new above threshold: the top-K residual of
                    # write-every-placement is exhausted for this image
                    break
            if qp.full:
                # cache is all support vectors even after pruning
                # (train.m:104-107)
                break

        model.interval = interval0

        qp.opt(tol=tol)
        if verbose:
            print(
                f"train iter {it}: n={qp.n} lb={qp.lb:.4f} ub={qp.ub:.4f}"
            )
        model = adopt(layout.vec_to_model(qp.actual_w(), model))

        # threshold at the 5th-percentile positive score (train.m:110-113)
        pos_scores = qp.score_positives()
        if len(pos_scores):
            r = np.sort(pos_scores)
            model.thresh = float(r[int(np.ceil(len(r) * 0.05)) - 1])
    return model
