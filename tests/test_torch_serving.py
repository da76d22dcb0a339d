"""The torch port's serving APIs (detect_batch, detect_many, detect_stream,
detect_fn, detect_batch_fn) and its batched program against the JAX
package on the CPU.

The model and images of tests/test_detector.py:98-249: the synthetic
3-part model (seed 70) carried over with model_from_jax, seeded 90x100
frames. The port's serving paths run the same program as its detect, so
they give detect's candidates exactly; against the JAX package scores
agree to 1e-6 and part boxes to 1e-4, with components and mixtures
identical. The batched program (a leading image axis) gives each image
its single-frame root scores bit for bit.
"""

import numpy as np
import pytest
import torch

from partsbaseddetector_tpu import PartsBasedDetector as JaxDetector
from partsbaseddetector_tpu.models.model import make_synthetic_model
from partsbaseddetector_tpu_torch import PartsBasedDetector
from partsbaseddetector_tpu_torch.models.convert import model_from_jax
from partsbaseddetector_tpu_torch.models.model import pack_model, to_device
from partsbaseddetector_tpu_torch.pipeline import make_plan, root_scores


def _jax_model(thresh=-2.0):
    return make_synthetic_model(
        nparts=3, nmix=1, fsize=(4, 4), sbin=8, interval=2, thresh=thresh,
        seed=70,
    )


def _images(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(90, 100, 3) * 255).astype(np.float32) for _ in range(n)]


def _assert_same(got, want, score_tol=0.0, part_tol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert abs(a.score - b.score) <= score_tol, (a.score, b.score)
            np.testing.assert_allclose(a.parts, b.parts, rtol=0, atol=part_tol)
            assert a.component == b.component
            np.testing.assert_array_equal(a.mixtures, b.mixtures)


@pytest.fixture(scope="module")
def served():
    """The port's detector, its per-frame detect on three images, and
    the JAX package's detect_batch and detect_many on the same images."""
    jm = _jax_model()
    ims = _images(3)
    jdet = JaxDetector(jm, max_detections=32)
    det = PartsBasedDetector(model_from_jax(jm), max_detections=32, device="cpu")
    return dict(
        det=det, ims=ims, singles=[det.detect(im) for im in ims],
        jax_batch=jdet.detect_batch(ims),
        jax_many=jdet.detect_many(ims, microbatch=2),
    )


def test_detect_batch_matches_jax(served):
    got = served["det"].detect_batch(served["ims"])
    _assert_same(got, served["singles"])
    _assert_same(got, served["jax_batch"], 1e-6, 1e-4)


@pytest.mark.parametrize("micro", [1, 2, 3])
def test_detect_many_matches_jax(served, micro):
    got = served["det"].detect_many(served["ims"], microbatch=micro)
    _assert_same(got, served["singles"])
    _assert_same(got, served["jax_many"], 1e-6, 1e-4)
    assert served["det"].detect_many([], microbatch=micro) == []


def test_detect_many_pipelined_packed_matches_single():
    """Mirrors tests/test_detector.py::
    test_detect_many_pipelined_packed_matches_single: the uploader
    thread, device packing in groups of 8 (a full group and a tail of
    2) and the top-K cut."""
    det = PartsBasedDetector(model_from_jax(_jax_model()), max_detections=32,
                             device="cpu")
    ims = _images(10)
    singles = [det.detect(im) for im in ims]
    _assert_same(det.detect_many(ims, prefetch=4), singles)
    got_top = det.detect_many(ims, readback_top=4, prefetch=2)
    _assert_same(got_top, [s[:4] for s in singles])
    # top beyond the candidate budget is the full readback, not a desync
    _assert_same(det.detect_many(ims[:3], readback_top=10_000, prefetch=2),
                 singles[:3])
    with pytest.raises(ValueError):
        det.detect_many(ims[:2], readback_top=0)
    with pytest.raises(ValueError):
        det.detect_many(ims[:2], microbatch=2, readback_top=4)


def test_detect_many_first_call_microbatch_odd_count():
    """A fresh detector's first call is a microbatch-2 run over 3 images:
    the plan is built there and the list is padded with its last image."""
    jm = _jax_model()
    ims = _images(3, seed=5)
    det = PartsBasedDetector(model_from_jax(jm), max_detections=32, device="cpu")
    got = det.detect_many(ims, microbatch=2)
    assert len(got) == 3
    _assert_same(got, JaxDetector(jm, max_detections=32).detect_batch(ims),
                 1e-6, 1e-4)
    _assert_same(got, [det.detect(im) for im in ims])


def test_detect_stream_lookahead_zero_synchronous(served):
    got = list(served["det"].detect_stream(served["ims"], lookahead=0, workers=0))
    _assert_same(got, served["singles"])


def test_detect_stream_mixed_depth_frames():
    """Mirrors tests/test_depth_device.py:108-175: RGB-D pairs and bare
    frames interleaved (a gated chunk carries the device keep mask, a
    plain one does not, so the arity change flushes), float and uint
    wire frames, readback workers; against per-frame detect exactly and
    the JAX stream."""
    jm = make_synthetic_model(
        nparts=4, nmix=2, fsize=(4, 4), sbin=8, interval=1, thresh=-16.0,
        seed=31,
    )
    rng = np.random.RandomState(32)
    im = (rng.rand(64, 72, 3) * 255).astype(np.float32)
    depth = np.full(im.shape[:2], 1.0, dtype=np.float32)
    depth[:, 36:] = 9.0
    depth[20:40, :20] = 4.0
    frames = []
    for i in range(7):
        rgb = np.clip(im + i, 0, 255).astype(np.float32)
        if i % 3 == 0:
            frames.append((rgb, depth + 0.05 * i))
        elif i % 3 == 1:
            frames.append((rgb.astype(np.uint8),
                           ((depth + 0.05 * i) * 1000.0).astype(np.uint16)))
        else:
            frames.append(rgb)
    det = PartsBasedDetector(model_from_jax(jm), max_detections=64,
                             device_depth_filter=True, device="cpu")
    wants = [det.detect(*(f if isinstance(f, tuple) else (f,))) for f in frames]
    for kw in (dict(lookahead=4, workers=1, readback_batch=3),
               dict(lookahead=4, workers=2, readback_batch=2)):
        _assert_same(list(det.detect_stream(frames, **kw)), wants)
    jdet = JaxDetector(jm, max_detections=64, device_depth_filter=True)
    jgot = list(jdet.detect_stream(frames, lookahead=4, workers=1, readback_batch=3))
    assert sum(len(w) for w in wants) > 0
    _assert_same(wants, jgot, 1e-4, 1e-3)


def test_detect_fn_and_detect_batch_fn_are_device_programs(served):
    """detect_fn maps one device frame to the five device outputs;
    detect_batch_fn a stack to the same outputs with an image axis."""
    det, ims = served["det"], served["ims"]
    frames = torch.from_numpy(np.stack(ims))
    one = det.detect_fn((90, 100))(frames[0])
    assert [tuple(t.shape) for t in one] == [(32, 3, 4), (32,), (32,), (32,), (32, 3)]
    many = det.detect_batch_fn((90, 100), 3)(frames)
    for i in range(3):
        for a, b in zip(many, det.detect_fn((90, 100))(frames[i])):
            assert torch.equal(a[i], b)
    for a, b in zip(one, many):
        assert torch.equal(a, b[0])
    with pytest.raises(ValueError):
        det.detect_batch_fn((90, 100), 2)(frames)


def _root_scores_both(jm, imsize, bpo, engine, nimg=3):
    packed = pack_model(model_from_jax(jm))
    dm = to_device(packed, "cpu")
    plan = make_plan(packed, imsize, bpo)
    ims = torch.as_tensor(
        (np.random.RandomState(4).rand(nimg, *imsize, 3) * 255).astype(np.float32)
    )
    batched = root_scores(ims, packed, dm, plan, engine=engine)
    singles = [root_scores(im, packed, dm, plan, engine=engine) for im in ims]
    return batched, singles


@pytest.mark.parametrize(
    "engine,octave_offset", [("spatial", False), ("spatial", True), ("fourier", False)]
)
def test_batched_root_scores_equal_single_bit_for_bit(engine, octave_offset):
    """Every bucket's root scores, root mixtures and pointer tables of a
    3-image batch equal each image's single-frame ones. With a part one
    octave below its parent, the DP slices the finer bucket's scale axis
    ([:, :s]) and must not mix images there."""
    jm = make_synthetic_model(nparts=4, nmix=2, sbin=4, interval=2, seed=8)
    if octave_offset:
        for d in jm.defid[0][2]:
            jm.anchors[int(d)][2] = 1
    assert pack_model(model_from_jax(jm)).components[0].max_ds == int(octave_offset)
    batched, singles = _root_scores_both(jm, (64, 80), 1, engine)
    assert batched and all(b.rootv.dim() == 4 for b in batched)
    for i, single in enumerate(singles):
        assert len(single) == len(batched)
        for b, s in zip(batched, single):
            assert (b.bucket_index, b.component) == (s.bucket_index, s.component)
            assert torch.equal(b.rootv[i], s.rootv)
            assert torch.equal(b.rooti[i], s.rooti)
            assert sorted(b.tables) == sorted(s.tables)
            for p in s.tables:
                assert torch.equal(b.tables[p][i], s.tables[p])
