"""The port's QP/latent training support and drivers against the JAX
package's, on the same seeded inputs.

Mirrors the data, builder and score-reconstruction tests of
tests/test_training.py and tests/test_train_fast_e2e.py. The NumPy
copies (data.py, builder.py, annotate.py, features.py, the reference
pipeline) must give the JAX package's bits. The drivers (latent.train
and train_model) mine through the port's TPUMiner on the CPU, whose
scores differ from the JAX miner's in the last bits of f32; the QP
writes its features from the mined placements, which are exact, so the
trained weights must agree within 1e-6 (they agree bit for bit on these
inputs).
"""

import numpy as np
import pytest

from partsbaseddetector_tpu.models.model import (
    make_synthetic_model as jmake_synthetic_model,
)
from partsbaseddetector_tpu.ops import reference_pipeline as jrp
from partsbaseddetector_tpu.train import annotate as jannotate
from partsbaseddetector_tpu.train import builder as jbuilder
from partsbaseddetector_tpu.train import data as jdata
from partsbaseddetector_tpu.train import features as jfeatures
from partsbaseddetector_tpu.train.latent import train as jtrain
from partsbaseddetector_tpu.train.layout import ParamLayout as JParamLayout
from partsbaseddetector_tpu.train.trainmodel import train_model as jtrain_model
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.models.model import make_synthetic_model
from partsbaseddetector_tpu_torch.ops import reference_pipeline as rp
from partsbaseddetector_tpu_torch.train import annotate, builder, data, features
from partsbaseddetector_tpu_torch.train.latent import train
from partsbaseddetector_tpu_torch.train.layout import ParamLayout
from partsbaseddetector_tpu_torch.train.trainmodel import train_model


def _model_arrays(m):
    return [*m.filters, m.biases, *m.defs, *m.anchors]


def _assert_models_equal(got, want, atol=0.0):
    g, w = _model_arrays(got), _model_arrays(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    assert abs(got.thresh - want.thresh) <= atol
    for c in range(want.ncomponents):
        np.testing.assert_array_equal(got.parentid[c], want.parentid[c])
        for p in range(want.nparts(c)):
            np.testing.assert_array_equal(got.filterid[c][p], want.filterid[c][p])
            np.testing.assert_array_equal(got.defid[c][p], want.defid[c][p])
            np.testing.assert_array_equal(got.biasid[c][p], want.biasid[c][p])


def _check_reconstruction(model, im, ndet):
    """w . phi reproduces the DP root score (detect.m:139-146), and the
    port's pyramid features and reconstructed scores are the JAX
    package's bits."""
    dets = rp.detect_reference(im, model, thresh=-1e9)
    assert dets
    layout = ParamLayout.build(model)
    feats, scales, padx, pady = rp.feature_pyramid(im, model)
    jm_feats, jscales, jpadx, jpady = jrp.feature_pyramid(im, model)
    assert (padx, pady) == (jpadx, jpady)
    np.testing.assert_array_equal(scales, jscales)
    for f, jf in zip(feats, jm_feats):
        np.testing.assert_array_equal(f, jf)
    jlayout = JParamLayout.build(model)
    for d in dets[:ndet]:
        pl = features.Placement(
            level=d["level"], component=d["component"], xs=d["xs"],
            ys=d["ys"], mixtures=d["mixtures"],
        )
        got = features.reconstruct_score(model, layout, feats, pl)
        assert abs(got - d["score"]) < 1e-5, (got, d["score"])
        jpl = jfeatures.Placement(
            level=d["level"], component=d["component"], xs=d["xs"],
            ys=d["ys"], mixtures=d["mixtures"],
        )
        assert got == jfeatures.reconstruct_score(model, jlayout, feats, jpl)
        np.testing.assert_array_equal(
            features.placement_feature(model, layout, feats, pl),
            jfeatures.placement_feature(model, jlayout, feats, jpl),
        )
    return dets


def test_score_reconstruction_invariant():
    model = make_synthetic_model(
        nparts=5, nmix=2, fsize=(4, 4), sbin=8, interval=2, thresh=-1e9,
        seed=21,
    )
    rng = np.random.RandomState(0)
    im = (rng.rand(120, 140, 3) * 255).astype(np.float64)
    _check_reconstruction(model, im, 8)


def test_scale_offset_parts_and_invariant():
    """Parts an octave below the root (anchor ds=1, detect_fast.m:93-105):
    the child sits on the finer level and the invariant still holds."""
    model = make_synthetic_model(
        nparts=2, nmix=1, fsize=(3, 3), sbin=8, interval=2, thresh=-1e9,
        seed=60,
    )
    model.anchors[model.defid[0][1][0]][2] = 1  # ds = 1
    rng = np.random.RandomState(0)
    im = (rng.rand(130, 140, 3) * 255).astype(np.float64)
    dets = _check_reconstruction(model, im, 5)
    for d in dets[:5]:
        levels = features.part_levels(model, 0, d["level"])
        assert levels[1] == d["level"] - model.interval


def _keypoint_positives(rng):
    positives = []
    for _ in range(24):
        root = rng.rand(2) * 50 + 30
        p1 = root + [10 + rng.randn(), rng.randn()]
        p2 = p1 + ([0, 10] if rng.rand() > 0.5 else [0, -10]) + rng.randn(2) * 0.3
        positives.append({"points": np.stack([root, p1, p2]), "im": None})
    return positives


def test_point_to_box_and_cluster():
    pa = [0, 0, 1]

    def run(data_mod, builder_mod):
        positives = data_mod.point_to_box(
            _keypoint_positives(np.random.RandomState(5)), pa
        )
        kps = np.stack([ex["points"] for ex in positives])
        sizes = np.array([
            (ex["boxes"][0, 3] - ex["boxes"][0, 1] + 1,
             ex["boxes"][0, 2] - ex["boxes"][0, 0] + 1)
            for ex in positives
        ])
        deffeat = builder_mod.relative_part_positions(kps, sizes, (5, 5))
        idx = builder_mod.cluster_parts(deffeat, [1, 1, 2], pa, restarts=10)
        return positives, deffeat, idx

    positives, deffeat, idx = run(data, builder)
    assert positives[0]["boxes"].shape == (3, 4)
    # part 2 has two clear relative-offset clusters (above/below)
    rel = deffeat[2] - deffeat[1]
    up = rel[:, 1] > 0
    assert len(np.unique(idx[2])) == 2
    assert np.unique(idx[2][up]).size == 1
    assert np.unique(idx[2][~up]).size == 1
    assert idx[2][up][0] != idx[2][~up][0]

    jpositives, jdeffeat, jidx = run(jdata, jbuilder)
    for ex, jex in zip(positives, jpositives):
        np.testing.assert_array_equal(ex["boxes"], jex["boxes"])
    for a, b in zip(deffeat + idx, jdeffeat + jidx):
        np.testing.assert_array_equal(a, b)


def test_cluster_parts_poselet():
    rng = np.random.RandomState(7)
    feats, labels = [], []
    for i in range(30):
        root = np.zeros(2)
        p1 = root + [10, 0] + rng.randn(2) * 0.2
        up = i % 2 == 0
        p2 = p1 + ([0, 8] if up else [0, -8]) + rng.randn(2) * 0.2
        feats.append(np.stack([root, p1, p2]))
        labels.append(up)
    kps = np.stack(feats)
    deffeat = [kps[:, p, :] for p in range(3)]
    labels = np.array(labels)

    co = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]])  # chain 0-1-2
    idx = builder.cluster_parts_poselet(deffeat, [1, 2, 2], co, restarts=10)
    assert np.unique(idx[1][labels]).size == 1
    assert np.unique(idx[1][~labels]).size == 1
    assert idx[1][labels][0] != idx[1][~labels][0]
    for a, b in zip(
        idx, jbuilder.cluster_parts_poselet(deffeat, [1, 2, 2], co, restarts=10)
    ):
        np.testing.assert_array_equal(a, b)

    co_parent = np.array([[0, 1, 0], [1, 0, 0], [0, 1, 0]])
    idx2 = builder.cluster_parts_poselet(deffeat, [1, 1, 2], co_parent, restarts=5)
    assert idx2[2].shape == (30,)
    assert np.unique(idx2[2][labels]).size == 1

    with pytest.raises(ValueError):
        builder.cluster_parts_poselet(deffeat, [1, 1, 1], np.zeros((3, 3)), restarts=1)


def test_build_and_merge_model():
    def run(b):
        rng = np.random.RandomState(6)
        pa = [0, 0]
        n = 10
        deffeat = [rng.rand(n, 2) * 5, rng.rand(n, 2) * 5 + 3]
        idx = [np.zeros(n, dtype=np.int64), (rng.rand(n) > 0.5).astype(np.int64)]
        base = b.init_part_model([(40, 40)] * n, sbin=8)
        pm0 = b.init_part_model([(40, 40)] * n, sbin=8)
        pm1 = b.init_part_model([(40, 40)] * n, sbin=8)
        pm1.filters = [pm1.filters[0], pm1.filters[0] + 1]
        model = b.build_model("t", [pm0, pm1], deffeat, idx, pa, base)
        return model, b.merge_models([model, model])

    model, merged = run(builder)
    model.validate()
    assert model.nparts(0) == 2
    assert model.nmixtures(0, 1) == 2
    assert model.biasid[0][1].shape == (1, 2)
    merged.validate()
    assert merged.ncomponents == 2
    np.testing.assert_allclose(merged.filters[len(model.filters)], model.filters[0])
    jmodel, jmerged = run(jbuilder)
    _assert_models_equal(model, jmodel)
    _assert_models_equal(merged, jmerged)


def test_crop_and_warp_positive():
    """croppos.m and warppos.m: the cropped example and the warped
    positive's HOG block (PIL's bilinear resize, imported lazily) are the
    JAX package's bits."""
    rng = np.random.RandomState(8)
    ex = {
        "im": (rng.rand(90, 100) * 255).astype(np.float64),  # grey
        "points": np.array([[40.0, 30.0], [44.0, 52.0]]),
        "boxes": np.array([[28.0, 18.0, 52.0, 42.0], [32.0, 40.0, 56.0, 64.0]]),
    }
    got, want = data.crop_positive(ex), jdata.crop_positive(ex)
    assert got["im"].shape[2] == 3
    for key in ("im", "boxes", "points"):
        np.testing.assert_array_equal(got[key], want[key])
    feat = data.warp_positive_feature(got, got["boxes"][1], (4, 4), 8)
    assert feat.shape == (4, 4, 32)
    np.testing.assert_array_equal(
        feat, jdata.warp_positive_feature(want, want["boxes"][1], (4, 4), 8)
    )


def test_annotations_and_datasets(tmp_path):
    ann = {f"im{i}.png": np.array([[i, 2.0 * i], [3.0, 4.5]]) for i in range(6)}
    ann["skip.txt"] = np.zeros((2, 2))
    for name in ann:
        (tmp_path / name).write_bytes(b"")
    path = str(tmp_path / "ann.json")
    annotate.save_annotations(path, ann)
    loaded = annotate.load_annotations(path)
    assert loaded.keys() == jannotate.load_annotations(path).keys() == ann.keys()
    train_set, test_set = annotate.get_positive_data(str(tmp_path), path, seed=3)
    jtrain_set, jtest_set = jannotate.get_positive_data(str(tmp_path), path, seed=3)
    assert len(train_set) == len(test_set) == 3
    for a, b in zip(train_set + test_set, jtrain_set + jtest_set):
        assert a["im"] == b["im"]
        np.testing.assert_array_equal(a["points"], b["points"])
    negs = annotate.get_negative_data(str(tmp_path), limit=4)
    assert negs == jannotate.get_negative_data(str(tmp_path), limit=4)
    assert len(negs) == 4
    pts = loaded["im5.png"]
    np.testing.assert_array_equal(
        annotate.map_rotate_points(pts, (40, 60), 30.0),
        jannotate.map_rotate_points(pts, (40, 60), 30.0),
    )
    np.testing.assert_allclose(
        annotate.map_rotate_points(pts, (40, 60), 360.0), pts, atol=1e-9
    )


def test_pyramid_kernels_give_the_pipelines_features():
    """feature_pyramid with ops/pyramid.py::PyramidKernels builds the
    detect pipeline's own features (build_pyramid_features, which the
    miner scores) bit for bit, and the JAX package's float64 reference
    features within 1e-4."""
    import torch

    from partsbaseddetector_tpu_torch.models import pack_model
    from partsbaseddetector_tpu_torch.ops.pyramid import (
        PyramidKernels,
        build_pyramid_features,
    )
    from partsbaseddetector_tpu_torch.pipeline import make_plan

    model = make_synthetic_model(
        nparts=5, nmix=2, fsize=(4, 4), sbin=8, interval=2, thresh=-1e9,
        seed=21,
    )
    im = (np.random.RandomState(0).rand(120, 140, 3) * 255).astype(np.float64)
    feats, scales, padx, pady = rp.feature_pyramid(
        im, model, kernels=PyramidKernels("cpu")
    )
    want, jscales, jpadx, jpady = jrp.feature_pyramid(im, model)
    assert (padx, pady) == (jpadx, jpady)
    np.testing.assert_array_equal(scales, jscales)
    assert len(feats) == len(want)
    for f, w in zip(feats, want):
        assert f.dtype == np.float64 and f.shape == w.shape
        np.testing.assert_allclose(f, w, rtol=0, atol=1e-4)

    packed = pack_model(model)
    plan = make_plan(packed, im.shape[:2])
    dev = build_pyramid_features(
        torch.as_tensor(im, dtype=torch.float32)[None], plan, packed.spec
    )
    for b, bucket in enumerate(plan.buckets):
        for k, s in enumerate(bucket.scale_indices):
            h, w = feats[s].shape[:2]
            np.testing.assert_array_equal(
                dev[b][0, k, :h, :w].double().numpy(), feats[s]
            )


def _latent_round(make, trainer, **kw):
    """tests/test_qp_sparse.py's latent smoke set-up: one positive with
    two part boxes and one negative at 96x96, one round."""
    model = make(
        nparts=2, nmix=1, fsize=(3, 3), sbin=8, interval=2, thresh=-1e9,
        seed=11,
    )
    rng = np.random.RandomState(4)
    im_pos = (rng.rand(96, 96, 3) * 255).astype(np.float64)
    boxes = np.asarray([[24.0, 24.0, 48.0, 48.0], [40.0, 40.0, 64.0, 64.0]])
    positives = [{"im": im_pos, "points": None, "boxes": boxes}]
    negatives = [{"im": (rng.rand(96, 96, 3) * 255).astype(np.float64)}]
    return trainer(
        model, positives, negatives, warp=False, iters=1, miner="tpu",
        nmax=200, max_neg_per_image=8, **kw,
    )


def test_latent_train_with_pyramid_kernels(monkeypatch):
    """latent.train with the features a card miner takes
    (PyramidKernels, here run on the CPU): the QP features come from the
    pipeline's f32 pyramid instead of the float64 reference; the trained
    weights agree with the CPU miner's within 1e-6."""
    import torch

    from partsbaseddetector_tpu_torch.ops.pyramid import PyramidKernels
    from partsbaseddetector_tpu_torch.train import latent

    want = _latent_round(make_synthetic_model, train, device="cpu")
    assert latent._feature_kernels(torch.device("cpu")) is latent.reference
    monkeypatch.setattr(
        latent, "_feature_kernels", lambda device: PyramidKernels(device)
    )
    got = _latent_round(make_synthetic_model, train, device="cpu")
    got.validate()
    _assert_models_equal(got, want, atol=1e-6)


def test_latent_train_with_the_port_miner():
    """latent.train with miner='tpu' (the port's TPUMiner on the CPU,
    hard negatives at interval 2) against the JAX trainer with its
    jitted miner: the same weights within 1e-6."""
    got = _latent_round(make_synthetic_model, train, device="cpu")
    want = _latent_round(jmake_synthetic_model, jtrain)
    got.validate()
    assert np.isfinite(got.thresh)
    assert got.interval == 2
    _assert_models_equal(got, model_from_jax(want), atol=1e-6)


def _scene(rng, with_object=True, size=72):
    """tests/test_train_fast_e2e.py's scene: a red root square above a
    blue part square on noise."""
    im = rng.rand(size, size, 3) * 40
    points = None
    if with_object:
        cx = rng.randint(22, size - 26)
        cy = rng.randint(22, size - 40)
        im[cy - 8 : cy + 8, cx - 8 : cx + 8, 0] += 200  # root: red
        im[cy + 10 : cy + 26, cx - 8 : cx + 8, 2] += 200  # part: blue
        points = np.array([[cx, cy], [cx, cy + 18]], dtype=np.float64)
    return np.clip(im, 0, 255), points


def test_tiny_train_round_trip(tmp_path):
    """tests/test_train_fast_e2e.py through the port's train_model on the
    CPU: warped-positive init, latent positives, interleaved hard
    negatives, QP. The trained model separates held-out scenes from
    noise, and its weights are the JAX train_model's within 1e-6."""

    def data_set():
        rng = np.random.RandomState(0)
        positives = []
        for _ in range(6):
            im, pts = _scene(rng, True)
            positives.append({"im": im, "points": pts})
        negatives = [{"im": _scene(rng, False)[0]} for _ in range(2)]
        return positives, negatives

    kw = dict(K=[1, 1], pa=[0, 0], sbin=8, interval=2, warp_iters=1,
              latent_iters=1, nmax=150)
    model = train_model(
        "toy2-fast", *data_set(), cachedir=str(tmp_path / "port"),
        device="cpu", **kw,
    )
    model.validate()
    assert model.nparts(0) == 2

    im_pos, pts = _scene(np.random.RandomState(91), True)
    im_neg, _ = _scene(np.random.RandomState(92), False)
    d_pos = rp.detect_reference(im_pos, model, thresh=-1e9)[0]
    d_neg = rp.detect_reference(im_neg, model, thresh=-1e9)[0]
    assert d_pos["score"] > d_neg["score"], (d_pos["score"], d_neg["score"])
    bx = d_pos["boxes"][0]
    cx, cy = 0.5 * (bx[0] + bx[2]), 0.5 * (bx[1] + bx[3])
    assert abs(cx - pts[0, 0]) < 18 and abs(cy - pts[0, 1]) < 18, ((cx, cy), pts[0])

    want = jtrain_model(
        "toy2-fast", *data_set(), cachedir=str(tmp_path / "jax"), **kw
    )
    _assert_models_equal(model, model_from_jax(want), atol=1e-6)
