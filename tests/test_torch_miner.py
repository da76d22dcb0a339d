"""The torch port's mining detector (train/detect_tpu.py::TPUMiner)
against the JAX package's TPUMiner (jit on the CPU) and the NumPy
reference detect_reference, on the same seeded inputs.

Mirrors tests/test_detect_tpu.py. Placements (level, component, per-part
grid coords, mixtures) must be exact, because the QP writes its feature
vectors from them; scores within 1e-4 * max(1, |s|) of JAX and 2e-3 of
the reference; boxes as in tests/test_detect_tpu.py (5e-2 abs, 1e-4
rel). On the CPU the port's route is the plain version of every kernel
(the inference route of pipeline.root_scores, -inf masking), while the
JAX miner runs its training route (-1e10 masking); the all-False-mask
case shows that the two masking values cut the same placements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu.models.model import pack_model as jpack
from partsbaseddetector_tpu.ops.reference_pipeline import (
    detect_reference as jdetect_reference,
)
from partsbaseddetector_tpu.pipeline import make_plan as jplan
from partsbaseddetector_tpu.pipeline import root_scores as jroot_scores
from partsbaseddetector_tpu.train.detect_tpu import TPUMiner as JaxMiner
from partsbaseddetector_tpu.train.sgd import model_params as jmodel_params
from partsbaseddetector_tpu_torch.models import pack_model, to_device
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.pipeline import make_plan, root_scores
from partsbaseddetector_tpu_torch.train.detect_tpu import (
    _NEG_THRESH,
    TPUMiner,
)

BOXES3 = np.array(
    [
        [30.0, 30.0, 65.0, 65.0],
        [40.0, 55.0, 75.0, 90.0],
        [55.0, 35.0, 90.0, 70.0],
    ]
)


def _model3():
    return make_synthetic_model(
        nparts=3, nmix=2, fsize=(4, 4), sbin=8, interval=3, thresh=-1.0,
        seed=3,
    )


def _octave_model():
    """A part an octave below the root (anchor ds=1)."""
    model = make_synthetic_model(
        nparts=2, nmix=1, fsize=(3, 3), sbin=8, interval=2, thresh=-1e9,
        seed=60,
    )
    model.anchors[model.defid[0][1][0]][2] = 1
    return model


def _image(shape, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape, 3) * 255).astype(np.float32)


def _jax_roots(im, packed, plan, masks, params=None):
    """The JAX root maps (rootv, rooti) per (bucket, component), jitted
    (one compile instead of one per primitive)."""
    fn = jax.jit(
        lambda im_, params_, masks_: [
            (s.rootv, s.rooti)
            for s in jroot_scores(
                im_, packed, plan, params=params_, response_masks=masks_
            )
        ]
    )
    out = fn(jnp.asarray(im), params, [jnp.asarray(m) for m in masks])
    return [(np.asarray(v), np.asarray(i)) for v, i in out]


def _assert_same(got, want, score_tol):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= score_tol(w["score"]), (
            g["score"], w["score"],
        )
        assert g["component"] == w["component"]
        assert g["level"] == w["level"], (g["level"], w["level"])
        np.testing.assert_array_equal(g["xs"], w["xs"])
        np.testing.assert_array_equal(g["ys"], w["ys"])
        np.testing.assert_array_equal(g["mixtures"], w["mixtures"])
        np.testing.assert_allclose(
            g["boxes"], w["boxes"], atol=5e-2, rtol=1e-4
        )


def _assert_parity(got, jax_dets, ref_dets):
    _assert_same(got, jax_dets, lambda s: 1e-4 * max(1.0, abs(s)))
    _assert_same(got, ref_dets, lambda s: 2e-3)


def test_plain_mining_parity():
    """Hard-negative mining contract: top detections with grid coords."""
    jm = _model3()
    im = _image((120, 140))
    got = TPUMiner(model_from_jax(jm), max_det=32, device="cpu").detect(
        im, thresh=-1e8
    )[:20]
    want = JaxMiner(jm, max_det=32).detect(im, thresh=-1e8)[:20]
    _assert_parity(got, want, jdetect_reference(im, jm, thresh=-1e8)[:20])


@pytest.mark.parametrize("fixed", [False, True], ids=["free", "fixed_mixtures"])
def test_latent_mining_parity(fixed):
    """Per-part IoU masks select detect.m's single best placement; with
    fixed mixtures ONLY the mixture constraint applies (detect.m:88-99)."""
    jm = _model3()
    im = _image((120, 140))
    fm = np.array([1, 0, 1]) if fixed else None
    kw = dict(thresh=-1e8, part_boxes=BOXES3, overlap=0.3, fixed_mixtures=fm)
    got = TPUMiner(model_from_jax(jm), max_det=32, device="cpu").detect(im, **kw)
    want = JaxMiner(jm, max_det=32).detect(im, **kw)
    ref = jdetect_reference(im, jm, **kw)
    assert len(got) == 1
    _assert_parity(got, want, ref)
    if fixed:
        np.testing.assert_array_equal(got[0]["mixtures"], fm)


@pytest.mark.parametrize(
    "case", ["free", "fixed_mixtures", "octave"],
)
def test_latent_masks_equal_jax(case):
    """The per-bucket (S, Hr, Wr, F) latent masks are the JAX miner's,
    bit for bit (the port builds them filter-major, one IoU test per part
    and filter size)."""
    jm = _octave_model() if case == "octave" else _model3()
    imshape = (104, 112) if case == "octave" else (120, 140)
    boxes = (np.array([[16.0, 16.0, 63.0, 63.0], [28.0, 32.0, 51.0, 55.0]])
             if case == "octave" else BOXES3)
    fm = np.array([1, 0, 1]) if case == "fixed_mixtures" else None
    jminer = JaxMiner(jm, max_det=8)
    _, jpacked, jplan_ = jminer._get_fn(imshape, True)
    want = jminer._latent_masks(jpacked, jplan_, boxes, 0.3, fm)
    miner = TPUMiner(model_from_jax(jm), max_det=8, device="cpu")
    packed, plan, _ = miner._get_plan(imshape)
    got = miner._latent_masks(packed, plan, boxes, 0.3, fm)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == bool and g.flags.c_contiguous
        np.testing.assert_array_equal(g, w)
        assert w.any() and not w.all()


def test_set_model_without_replanning():
    """set_model adopts new weights with the same plans (the QP loop
    updates the weights every iteration), and gives what a fresh miner
    on the new weights gives, bit for bit."""
    jm = make_synthetic_model(
        nparts=2, nmix=2, fsize=(4, 4), sbin=8, interval=2, thresh=-1.0,
        seed=7,
    )
    rng = np.random.RandomState(1)
    im = (rng.rand(110, 120, 3) * 255).astype(np.float32)
    tm = model_from_jax(jm)
    miner = TPUMiner(tm, max_det=16, device="cpu")
    _assert_parity(
        miner.detect(im, thresh=-1e8)[:10],
        JaxMiner(jm, max_det=16).detect(im, thresh=-1e8)[:10],
        jdetect_reference(im, jm, thresh=-1e8)[:10],
    )
    plans = dict(miner._plans)

    # perturb the weights in place (what vec_to_model does each round)
    for f in jm.filters:
        f += rng.randn(*f.shape).astype(np.float32) * 0.05
    jm.biases = jm.biases + 0.1
    tm = model_from_jax(jm)
    miner.set_model(tm)
    got = miner.detect(im, thresh=-1e8)[:10]
    _assert_parity(
        got,
        JaxMiner(jm, max_det=16).detect(im, thresh=-1e8)[:10],
        jdetect_reference(im, jm, thresh=-1e8)[:10],
    )
    assert miner._plans.keys() == plans.keys()
    assert all(miner._plans[k] is plans[k] for k in plans), "re-planned"
    fresh = TPUMiner(tm, max_det=16, device="cpu").detect(im, thresh=-1e8)
    assert len(fresh) >= 10
    for g, w in zip(got, fresh):
        assert g["score"] == w["score"]
        np.testing.assert_array_equal(g["boxes"], w["boxes"])


def test_negative_mining_interval_gets_its_own_plan():
    """latent.train drops model.interval to 2 for hard negatives on the
    object the miner holds: the plan key carries the interval."""
    jm = _model3()
    im = _image((120, 140))
    tm = model_from_jax(jm)
    miner = TPUMiner(tm, max_det=32, device="cpu")
    miner.detect(im, thresh=-1e8)
    tm.interval = jm.interval = 2
    got = miner.detect(im, thresh=-1e8)[:20]
    assert sorted(miner._plans) == [(120, 140, 2), (120, 140, 3)]
    _assert_parity(
        got,
        JaxMiner(jm, max_det=32).detect(im, thresh=-1e8)[:20],
        jdetect_reference(im, jm, thresh=-1e8)[:20],
    )


@pytest.mark.parametrize("latent", [False, True], ids=["plain", "latent"])
def test_octave_offset_part_mining_parity(latent):
    """A part an octave below the root (ds=1): the placements and the
    latent masks track the finer grid (the part's mask comes from the
    finer bucket's box scale). tests/test_detect_tpu.py's slow case at a
    smaller frame: 104x112 still holds a root level an octave above a
    part level."""
    jm = _octave_model()
    im = _image((104, 112))
    kw = dict(thresh=-1e8)
    if latent:
        kw.update(
            part_boxes=np.array([[16.0, 16.0, 63.0, 63.0],
                                 [28.0, 32.0, 51.0, 55.0]]),
            overlap=0.3,
        )
    got = TPUMiner(model_from_jax(jm), max_det=16, device="cpu").detect(
        im, **kw
    )[:10]
    want = JaxMiner(jm, max_det=16).detect(im, **kw)[:10]
    ref = jdetect_reference(im, jm, **kw)[:10]
    _assert_parity(got, want, ref)
    assert all(d["level"] >= jm.interval for d in got)


def test_all_false_part_mask_cuts_the_same_placements():
    """A part box small enough that no window overlaps it enough at the
    coarse scales: the part's filters are masked everywhere there. The
    port masks with -inf, the JAX miner with -1e10; the roots valid
    after the -1e9 cut are the same, with the same scores and pointers,
    and the mined placement is the same."""
    jm = _model3()
    im = _image((120, 140))
    boxes = BOXES3.copy()
    boxes[1] = [44.0, 60.0, 75.0, 91.0]  # 32 px: the size of one window
    overlap = 0.5
    tm = model_from_jax(jm)
    miner = TPUMiner(tm, max_det=32, device="cpu")
    packed, plan, _ = miner._get_plan(im.shape[:2])
    masks = miner._latent_masks(packed, plan, boxes, overlap, None)
    f1 = packed.components[0].filterid[1]
    # per scale: no cell where any mixture of part 1 may sit
    dead = ~np.concatenate(
        [m[..., f1].reshape(m.shape[0], -1).any(axis=1) for m in masks]
    )
    assert dead.any() and not dead.all(), dead

    # the root maps: -inf masking (port, inference) against -1e10 (JAX,
    # training route with the weights as params)
    jp = jpack(jm)
    jpl = jplan(jp, im.shape[:2])
    want = _jax_roots(im, jp, jpl, masks, params=jmodel_params(jm))
    got = root_scores(
        torch.as_tensor(im), packed, to_device(packed, "cpu"), plan,
        response_masks=[torch.as_tensor(m) for m in masks],
    )
    ncut = 0
    for g, (wv, wi) in zip(got, want):
        gv = g.rootv.numpy()
        valid = wv >= _NEG_THRESH
        np.testing.assert_array_equal(gv >= _NEG_THRESH, valid)
        assert not np.isfinite(gv[~valid]).any()
        ncut += int((~valid).sum())
        np.testing.assert_allclose(gv[valid], wv[valid], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            g.rooti.numpy()[valid], wi[valid]
        )
    assert ncut > 0

    kw = dict(thresh=-1e8, part_boxes=boxes, overlap=overlap)
    got_d = miner.detect(im, **kw)
    _assert_parity(
        got_d,
        JaxMiner(jm, max_det=32).detect(im, **kw),
        jdetect_reference(im, jm, **kw),
    )


def test_shared_filters_take_the_reference_route():
    """Two parts sharing a filter would entangle their masks: latent
    mining hands the image to detect_reference, as the JAX miner does,
    and builds no plan."""
    jm = _model3()
    jm.filterid[0][2] = jm.filterid[0][1].copy()
    im = _image((96, 104))
    kw = dict(thresh=-1e8, part_boxes=BOXES3, overlap=0.3)
    miner = TPUMiner(model_from_jax(jm), max_det=32, device="cpu")
    got = miner.detect(im, **kw)
    assert miner._plans == {}
    want = JaxMiner(jm, max_det=32).detect(im, **kw)
    assert len(got) == len(want) == 1
    assert got[0].keys() == want[0].keys()
    for key, val in want[0].items():
        np.testing.assert_array_equal(got[0][key], val)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_is_the_card():
    model = model_from_jax(_model3())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPUMiner(model)
    from partsbaseddetector_tpu_torch.train import train, train_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(model, [], [], iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_model("t", [], [], K=[1], pa=[0])


@pytest.mark.parametrize(
    "form,batch",
    [("positional", 1), ("per_filter", 1), ("per_filter", 2)],
    ids=["3d", "4d", "4d_batch2"],
)
def test_root_scores_masks_match_jax(form, batch):
    """root_scores with (S, Hr, Wr) and (S, Hr, Wr, F) masks against the
    JAX root_scores with the same masks (both inference routes, -inf
    masking); a batch broadcasts the masks over its images."""
    jm = _model3()
    ims = np.stack([_image((96, 104), seed=s) for s in range(batch)])
    jp = jpack(jm)
    jpl = jplan(jp, ims.shape[1:3])
    tp = pack_model(model_from_jax(jm))
    plan = make_plan(tp, ims.shape[1:3])
    rng = np.random.RandomState(5)
    nf = tp.filters.shape[0]
    masks = []
    for b in plan.buckets:
        shape = (len(b.scale_indices), b.resp_h, b.resp_w)
        if form == "per_filter":
            shape += (nf,)
        masks.append(rng.rand(*shape) < 0.8)
    got = root_scores(
        torch.as_tensor(ims), tp, to_device(tp, "cpu"), plan,
        response_masks=[torch.as_tensor(m) for m in masks],
    )
    for i in range(batch):
        want = _jax_roots(ims[i], jp, jpl, masks)
        assert len(got) == len(want)
        for g, (wv, wi) in zip(got, want):
            gv = g.rootv[i].numpy()
            fin = np.isfinite(wv)
            np.testing.assert_array_equal(np.isfinite(gv), fin)
            assert fin.any()
            np.testing.assert_allclose(gv[fin], wv[fin], rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(
                g.rooti[i].numpy()[fin], wi[fin]
            )
