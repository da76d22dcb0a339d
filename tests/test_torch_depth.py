"""The torch port's RGB-D detection against the JAX package on the CPU.

Mirrors tests/test_depth_gate.py and tests/test_depth_device.py:

  - the plausible-depth response gates (pipeline.depth_response_masks)
    equal the host predictor depth.depth_level_mask and the JAX gates bit
    for bit;
  - a gated detect gives the JAX gated detect's candidates (scores to
    1e-4, boxes to 1e-3, mixtures exact); unknown depth gates nothing;
    detect(im, depth) composes the gate and the candidate filter;
  - device box medians are exact (Math::median, the upper middle) within
    the 48 px budget and equal the JAX ones; the device keep mask equals
    the host filter and the JAX keep mask; a uint16 millimetre frame
    gives what the same frame in float metres gives.
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu import depth as jdepth
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu.models.model import pack_model as jpack
from partsbaseddetector_tpu.ops import depth_device as jdd
from partsbaseddetector_tpu.pipeline import depth_response_masks as jmasks
from partsbaseddetector_tpu.pipeline import make_plan as jplan
from partsbaseddetector_tpu_torch import PartsBasedDetector
from partsbaseddetector_tpu_torch import depth as tdepth
from partsbaseddetector_tpu_torch.models import pack_model
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.ops import depth_device as tdd
from partsbaseddetector_tpu_torch.pipeline import depth_response_masks, make_plan

GATE = dict(object_width_m=0.4, fx=80.0, tolerance=0.5)


def _model(seed=10, **kw):
    args = dict(nparts=4, nmix=2, fsize=(4, 4), sbin=8, interval=3, thresh=-1e9)
    args.update(kw)
    return make_synthetic_model(seed=seed, **args)


def _split_depth(shape):
    """Left half at 2.5 m (plausible at every scale), right half at 20 m
    (implausible at every scale): tests/test_depth_gate.py::_split_depth."""
    depth = np.full(shape, 2.5, dtype=np.float32)
    depth[:, shape[1] // 2:] = 20.0
    return depth


def _assert_same(got, want, exact=False):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if exact:
            assert g.score == w.score
            np.testing.assert_array_equal(g.parts, w.parts)
        else:
            assert abs(g.score - w.score) < 1e-4, (g.score, w.score)
            np.testing.assert_allclose(g.parts, w.parts, atol=1e-3)
        assert g.component == w.component
        np.testing.assert_array_equal(g.mixtures, w.mixtures)


@pytest.mark.parametrize(
    "border,depth_shape", [("matlab", (170, 190)), ("cpp", (170, 190)),
                           ("matlab", (85, 120))]
)
def test_device_masks_equal_host_predictor_and_jax(border, depth_shape):
    jm = _model()
    packed = pack_model(model_from_jax(jm), border=border)
    imsize = (170, 190)
    plan = make_plan(packed, imsize, 3)
    depth = _split_depth(depth_shape)
    depth[5:9, 7:30] = 0.0  # unknown depth passes
    depth[40:44, 3:9] = np.nan
    gate = tdepth.DepthGate(**GATE)
    got = depth_response_masks(torch.from_numpy(depth), plan, packed.spec, gate)
    jp = jpack(jm, border=border)
    want = jmasks(depth, jplan(jp, imsize, 3), jp.spec, jdepth.DepthGate(**GATE))
    off = -1 if border == "cpp" else -packed.spec.padx, -1 if border == "cpp" else -packed.spec.pady
    masked = 0
    for b, bucket in enumerate(plan.buckets):
        g = got[b].numpy()
        np.testing.assert_array_equal(g, np.asarray(want[b]))
        for i, sidx in enumerate(bucket.scale_indices):
            host = tdepth.depth_level_mask(
                depth, g[i].shape, plan.scales[sidx].box_scale, off[0],
                off[1], imsize, gate,
            )
            np.testing.assert_array_equal(g[i], host)
            masked += int((~host).sum())
    assert masked > 0


def test_gated_detect_matches_jax():
    jm = _model()
    im = (np.random.RandomState(0).rand(170, 190, 3) * 255).astype(np.float32)
    depth = _split_depth(im.shape[:2])
    want = JaxDetector(jm, max_detections=96, depth_gate=jdepth.DepthGate(**GATE))
    got = PartsBasedDetector(
        model_from_jax(jm), max_detections=96, depth_gate=tdepth.DepthGate(**GATE),
        device="cpu",
    )
    gated = got.detect_dense(im, depth).to_candidates()
    _assert_same(gated, want.detect_dense(im, depth).to_candidates())
    # the gate changes the candidate set
    plain = got.detect_dense(im).to_candidates()
    assert [c.score for c in plain] != [c.score for c in gated]


def test_unknown_depth_gates_nothing():
    model = model_from_jax(_model(seed=11))
    im = (np.random.RandomState(1).rand(120, 140, 3) * 255).astype(np.float32)
    det = PartsBasedDetector(model, max_detections=64, device="cpu",
                             depth_gate=tdepth.DepthGate(**GATE))
    plain = det.detect_dense(im).to_candidates()
    gated = det.detect_dense(im, np.zeros(im.shape[:2], np.float32)).to_candidates()
    _assert_same(gated, plain, exact=True)


def test_detect_applies_gate_and_candidate_filter():
    jm = _model(seed=12)
    im = (np.random.RandomState(2).rand(160, 180, 3) * 255).astype(np.float32)
    depth = np.full(im.shape[:2], 2.0, dtype=np.float32)
    depth[:, 90:] = 6.0  # plausible at the finest scales only
    det = PartsBasedDetector(model_from_jax(jm), max_detections=64, device="cpu",
                             depth_gate=tdepth.DepthGate(**GATE))
    cands = det.detect(im, depth)
    dense = det.detect_dense(im, depth).to_candidates()
    want = tdepth.filter_candidates_by_depth(det._packed, dense, depth)
    assert 0 < len(want) < len(dense), "fixture must reject some candidates"
    _assert_same(cands, want, exact=True)
    jdet = JaxDetector(jm, max_detections=64, depth_gate=jdepth.DepthGate(**GATE))
    _assert_same(cands, jdet.detect(im, depth))


def test_box_medians_exact_within_budget():
    rng = np.random.RandomState(0)
    depth = rng.rand(120, 160).astype(np.float32) * 5.0
    depth[10:20, 30:50] = np.nan
    depth[40:45, :10] = 0.0
    boxes = []
    for _ in range(64):
        x1, y1 = rng.randint(-5, 150), rng.randint(-5, 110)
        boxes.append([x1, y1, x1 + rng.randint(0, 47), y1 + rng.randint(0, 47)])
    boxes = np.asarray(boxes, dtype=np.float32)
    got = tdd.box_depth_medians(torch.from_numpy(depth), torch.from_numpy(boxes)).numpy()
    want = np.array([tdepth._median_depth(depth, b) for b in boxes.astype(np.float64)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jdd.box_depth_medians(depth, boxes)))


@pytest.mark.parametrize(
    "boxes,want",
    [
        ([[0, 0, 259, 199], [10, 10, 150, 180], [-20, -20, 500, 500]], 3.25),
        ([[300, 300, 310, 310], [10, 10, 9, 20], [-30, 5, -2, 9]], 0.0),
    ],
)
def test_box_medians_large_and_empty_boxes(boxes, want):
    depth = np.full((200, 260), 3.25, dtype=np.float32)
    boxes = np.asarray(boxes, np.float32)
    got = tdd.box_depth_medians(torch.from_numpy(depth), torch.from_numpy(boxes))
    np.testing.assert_array_equal(got.numpy(), np.full(3, want, np.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdd.box_depth_medians(depth, boxes)))


def test_component_tables_equal_jax():
    jm = make_synthetic_model(nparts=5, nmix=2, ncomponents=2, seed=3)
    got = tdd.component_tables(pack_model(model_from_jax(jm)))
    want = jdd.component_tables(jpack(jm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _single_scale_fixture(seed):
    """tests/test_depth_device.py::_single_scale_fixture: one scale on a
    64x72 image, part boxes within the exact-median budget."""
    jm = make_synthetic_model(
        nparts=4, nmix=2, fsize=(4, 4), sbin=8, interval=1, thresh=-16.0, seed=seed
    )
    im = (np.random.RandomState(seed + 1).rand(64, 72, 3) * 255).astype(np.float32)
    depth = np.full(im.shape[:2], 1.0, dtype=np.float32)
    depth[:, 36:] = 9.0
    depth[20:40, :20] = 4.0
    return jm, im, depth


def test_device_filter_matches_host_filter_and_jax():
    jm, im, depth = _single_scale_fixture(21)
    model = model_from_jax(jm)
    det_h = PartsBasedDetector(model, max_detections=64, device="cpu")
    det_d = PartsBasedDetector(model, max_detections=64, device_depth_filter=True,
                               device="cpu")
    want = det_h.detect(im, depth)
    got = det_d.detect(im, depth)
    assert len(det_h.detect(im)) > len(want) > 0, "fixture must reject some"
    _assert_same(got, want, exact=True)
    jdet = JaxDetector(jm, max_detections=64, device_depth_filter=True)
    np.testing.assert_array_equal(
        det_d.detect_dense(im, depth).depth_keep,
        jdet.detect_dense(im, depth).depth_keep,
    )
    _assert_same(got, jdet.detect(im, depth))


@pytest.mark.parametrize("stage", ["host_filter", "device_filter", "gate"])
def test_uint16_mm_depth_matches_float_meters(stage):
    """Fixture depths are whole millimetres, so mm -> m is exact in f32."""
    jm, im, depth = _single_scale_fixture(25)
    kw = dict(device_depth_filter=stage != "host_filter")
    if stage == "gate":
        # z = 2.5 m at the one scale: a 9 m corner is gated, too small
        # to move a part's median off 1 m
        jm.thresh = -1e9
        depth[:] = 1.0
        depth[:14, 56:] = 9.0
        kw["depth_gate"] = tdepth.DepthGate(object_width_m=0.5, fx=40.0, tolerance=0.9)
    mm = np.round(depth * 1000).astype(np.uint16)
    det = PartsBasedDetector(model_from_jax(jm), max_detections=64, device="cpu", **kw)
    _assert_same(det.detect(im, mm), det.detect(im, depth), exact=True)


def test_bad_depth_shape_raises():
    jm, im, _ = _single_scale_fixture(25)
    det = PartsBasedDetector(model_from_jax(jm), device_depth_filter=True, device="cpu")
    with pytest.raises(ValueError):
        det.detect(im, np.ones((64, 72, 1), np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_host_filter_medians_take_the_native_helper_for_float32_maps(monkeypatch, dtype):
    """The host depth filter's medians: 2-D float32 maps go to the
    port's native helper when it builds (as the JAX package's copy does),
    any other map to the NumPy loop; both give the reference's
    nth_element-at-n/2 value exactly, NaNs skipped, empty boxes 0."""
    from partsbaseddetector_tpu_torch import depth as tdepth
    from partsbaseddetector_tpu_torch import native

    rng = np.random.RandomState(4)
    d = (1 + rng.rand(60, 80)).astype(dtype)
    d[rng.rand(60, 80) < 0.1] = np.nan
    boxes = [[3, 4, 20, 30], [0, 0, 79, 59], [70, 50, 120, 90], [-5, -5, 10, 8],
             [40, 40, 40, 40], [30, 10, 20, 5]]
    calls = []
    real = native.box_medians
    monkeypatch.setattr(native, "box_medians",
                        lambda *a: calls.append(1) or real(*a))
    got = tdepth._batch_medians(d, boxes)
    want = np.array([tdepth._median_depth(d, b) for b in boxes])
    np.testing.assert_array_equal(got, want)
    assert len(calls) == int(dtype == np.float32 and native.available())
